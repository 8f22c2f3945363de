"""Preconditioned Crank-Nicolson in advancedmh_tpu_torch against
advancedmh_tpu.

- the proposal and the likelihood-only accept on JAX's prior draws ν and
  Exp(1) draws, against JAX's ``step_batched`` (1e-6, decisions equal), for
  the GP's MvNormal prior and a dict of Normal priors;
- tests/test_pcn.py's assertions on the torch engine, at their tolerances
  (more chains, fewer steps);
- the fused engine on its plain version (tests/test_pallas.py's pCN check on
  the d = 16 GP at 1024 chains, thin 4 included), a split run bit for bit,
  and the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models import gp_latent_model as jax_gp
from advancedmh_tpu_torch import (DensityModel, InverseGamma, MvNormal, Normal,
                                  PreconditionedCrankNicolson, Transition, sample)
from advancedmh_tpu_torch.models import gp_latent_model
from advancedmh_tpu_torch.ops import pcn_constants
from advancedmh_tpu_torch.utils.tree import tree_flatten


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_pcn_draws(key, priors, leaves):
    """The prior draws and Exp(1) draws of JAX's ``_step_impl`` (batched)."""
    k_nu, k_acc = jax.random.split(key)
    nu = []
    for k, d, leaf in zip(jax.random.split(k_nu, len(priors)), priors, leaves):
        base = d.sample(jax.random.key(0)).ndim
        nu.append(d.sample(k, jnp.shape(leaf)[: leaf.ndim - base]))
    return nu, jax.random.exponential(k_acc, (leaves[0].shape[0],))


def test_step_matches_jax_on_its_noise():
    C = 64
    rng = np.random.default_rng(0)
    (pm, pp, _), (jm, jp, _) = (gp_latent_model(16, noise=0.3, seed=3, device="cpu"),
                                jax_gp(16, noise=0.3, seed=3))
    jdict = ref.DensityModel(lambda x: ref.Normal(1.0, 0.5).log_prob(x["a"])
                             + jnp.sum(ref.Normal(-1.0, 0.5).log_prob(x["b"])))
    pdict = DensityModel(lambda x: Normal(1.0, 0.5).log_prob(x["a"])
                         + torch.sum(Normal(-1.0, 0.5).log_prob(x["b"])), device="cpu")
    cases = [
        (jm, pm, jp, pp, (np.asarray(jp.scale_tril) @ rng.normal(size=(16, C))).T),
        (jdict, pdict, {"a": ref.Normal(0.0, 1.0), "b": ref.MvNormal.standard(2)},
         {"a": Normal(0.0, 1.0), "b": MvNormal.standard(2, device="cpu")},
         {"a": rng.normal(size=C), "b": rng.normal(size=(C, 2))}),
    ]
    for jmod, pmod, jprior, pprior, x in cases:
        x = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), x)
        jx = jax.tree_util.tree_map(jnp.asarray, x)
        lp = jax.vmap(jmod.logdensity_fn)(jx)
        jst = ref.samplers.base.Transition(jx, lp, jnp.zeros(C, bool))
        pst = Transition(jax.tree_util.tree_map(_t, x), _t(lp), torch.zeros(C, dtype=torch.bool))
        jspl = ref.PreconditionedCrankNicolson(jprior, beta=0.3)
        pspl = PreconditionedCrankNicolson(pprior, beta=0.3)
        for i in range(3):
            key = jax.random.fold_in(jax.random.key(4), i)
            nu, e = _jax_pcn_draws(key, jax.tree_util.tree_leaves(
                jprior, is_leaf=lambda d: isinstance(d, ref.Distribution)),
                jax.tree_util.tree_leaves(jst.params))
            jst, _ = jspl.step_batched(key, jst, jmod, (C,))
            pst, _ = pspl.step_from_noise(pst, pmod, (C,), [_t(n) for n in nu], _t(e))
            np.testing.assert_array_equal(pst.accepted.numpy(), np.asarray(jst.accepted))
            for a, b in zip(tree_flatten(pst.params)[0], jax.tree_util.tree_leaves(jst.params)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(pst.lp.numpy(), np.asarray(jst.lp), rtol=1e-6, atol=1e-5)


def test_kernel_constants_round_once():
    rho, beta = pcn_constants(0.2)
    assert rho == float(np.float32(np.sqrt(1.0 - 0.04))) and beta == float(np.float32(0.2))


# ---- tests/test_pcn.py on the torch engine ----------------------------------------------


class TestPCNTorchEngine:
    def test_conjugate_posterior(self):
        model = DensityModel(lambda x: Normal(1.0, 0.5).log_prob(x["a"])
                             + Normal(-1.0, 0.5).log_prob(x["b"]), device="cpu")
        spl = PreconditionedCrankNicolson({"a": Normal(0.0, 1.0), "b": Normal(0.0, 1.0)},
                                          beta=0.3)
        res = sample(model, spl, 800, key=0, num_chains=256, discard_initial=300)
        a = res.transitions.params["a"].reshape(-1).numpy()
        b = res.transitions.params["b"].reshape(-1).numpy()
        np.testing.assert_allclose([a.mean(), b.mean()], [0.8, -0.8], atol=0.05)
        assert abs(a.var() - 0.2) < 0.05
        assert abs(np.corrcoef(a, b)[0, 1]) < 0.1

    def test_gp_latent_posterior(self):
        model, prior, aux = gp_latent_model(32, noise=0.3, seed=3, device="cpu")
        res = sample(model, PreconditionedCrankNicolson(prior, beta=0.15), 800, key=1,
                     num_chains=256, discard_initial=1500)
        draws = res.transitions.params.reshape(-1, 32).numpy()
        np.testing.assert_allclose(draws.mean(0), aux["post_mean"], atol=0.07)

    def test_beta_one_is_independence_sampler(self):
        model = DensityModel(lambda x: Normal(1.0, 0.5).log_prob(x), device="cpu")
        spl = PreconditionedCrankNicolson(Normal(0.0, 1.0), beta=1.0)
        res = sample(model, spl, 1000, key=2, num_chains=256, discard_initial=200)
        assert abs(res.transitions.params.reshape(-1).numpy().mean() - 0.8) < 0.05

    def test_acceptance_flat_in_dimension(self):
        rates = {}
        for d in (2, 64):
            model = DensityModel(lambda f: -0.125 * torch.sum(f * f), device="cpu")
            spl = PreconditionedCrankNicolson(MvNormal.standard(d, device="cpu"), beta=0.2)
            res = sample(model, spl, 300, key=3, num_chains=256, discard_initial=100)
            rates[d] = float(res.transitions.accepted.float().mean())
        assert rates[64] > 0.3 * rates[2]
        assert rates[64] > 0.2

    def test_errors(self):
        for beta in (0.0, 1.5):
            with pytest.raises(ValueError, match="beta"):
                PreconditionedCrankNicolson(Normal(0.0, 1.0), beta=beta)
        with pytest.raises(TypeError, match="Gaussian prior"):
            PreconditionedCrankNicolson(InverseGamma(2.0, 3.0)).init(
                torch.Generator(), DensityModel(lambda x: torch.zeros(()), device="cpu"))
        model = DensityModel(lambda x: Normal(0.0, 1.0).log_prob(x["a"]), device="cpu")
        spl = PreconditionedCrankNicolson({"a": Normal(0.0, 1.0), "b": Normal(0.0, 1.0)})
        with pytest.raises(ValueError, match="leaves"):
            sample(model, spl, 5, key=0, initial_params={"a": torch.zeros(())})


# ---- the fused engine on the plain version ----------------------------------------------


def test_fused_pcn_gp_analytic_posterior():
    """tests/test_pallas.py::test_fused_pcn_gp_analytic_posterior at 1024
    chains: the tril prior, starts drawn from the prior, and thin = 4."""
    model, prior, aux = gp_latent_model(16, noise=0.3, seed=3, device="cpu")
    spl = PreconditionedCrankNicolson(prior, beta=0.2)
    res = sample(model, spl, 300, key=11, num_chains=1024, engine="fused", discard_initial=500)
    p = res.transitions.params
    np.testing.assert_allclose(p.mean((0, 1)).numpy(), aux["post_mean"], atol=0.03)
    np.testing.assert_allclose(p.var((0, 1)).numpy(), np.diag(aux["post_cov"]), rtol=0.2,
                               atol=0.01)
    assert 0.2 < float(res.transitions.accepted.float().mean()) < 0.95
    res_t = sample(model, spl, 100, key=12, num_chains=512, engine="fused",
                   discard_initial=500, thinning=4)
    np.testing.assert_allclose(res_t.transitions.params.mean((0, 1)).numpy(), aux["post_mean"],
                               atol=0.05)


def test_fused_split_run_is_bit_exact():
    model, prior, _ = gp_latent_model(16, likelihood="logistic", seed=5, device="cpu")
    spl = PreconditionedCrankNicolson(prior, beta=0.3)
    kw = dict(key=6, num_chains=100, engine="fused")
    whole = sample(model, spl, 40, discard_initial=10, **kw)
    first = sample(model, spl, 15, discard_initial=10, **kw)
    rest = sample(model, spl, 25, discard_initial=1, initial_state=first.final_state,
                  iteration_offset=9 + 15, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))


def test_fused_errors():
    model, prior, _ = gp_latent_model(8, device="cpu")
    with pytest.raises(ValueError, match="single Normal/MvNormal"):
        sample(model, PreconditionedCrankNicolson({"a": prior}), 5, key=0, num_chains=4,
               engine="fused", initial_params=torch.zeros(8))
