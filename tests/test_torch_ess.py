"""Elliptical slice sampling and the GP latent field in advancedmh_tpu_torch
against advancedmh_tpu.

- ``gp_latent_model`` (both likelihoods, d = 16 and 64): data equal to the
  JAX package's, ``logdensity``, the batched density and the tile density
  against JAX's at rtol 1e-6 (atol 1e-5);
- ``EllipticalSlice.ess_move`` against JAX's ``step_batched`` driven by the
  random numbers JAX draws (ν, the Exp(1), θ₀ and the ``fold_in(k_shrink,
  i)`` trip uniforms): states and lp at 1e-5, flags equal, lanes that
  exhaust a small ``max_shrink`` included;
- tests/test_ess.py's assertions on the torch engine, at their tolerances;
- the fused engine on its plain version (tests/test_pallas.py's ESS checks
  at 1024 chains, the diagonal prior in place of the scalar custom density),
  split runs bit for bit, the errors, and ``convert.py``'s GP model and a
  JAX ESS state resumed on the fused engine.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models import gp_latent_model as jax_gp
from advancedmh_tpu_torch import (DensityModel, EllipticalSlice, InverseGamma, MvNormal,
                                  Normal, sample)
from advancedmh_tpu_torch.convert import gp_latent_from_numpy, transition_from_numpy
from advancedmh_tpu_torch.models import gp_latent_model

DATA = np.random.default_rng(7).normal(1.0, 1.0, size=20).astype(np.float32)
N_OBS = DATA.shape[0]
POST_MEAN = float(N_OBS * DATA.mean() / (N_OBS + 1))
POST_VAR = 1.0 / (N_OBS + 1)
LIKELIHOOD = DensityModel(
    lambda th: torch.sum(Normal(th, 1.0).log_prob(torch.as_tensor(DATA))), dimension=1,
    logdensity_batched_fn=lambda th: torch.sum(
        Normal(th[..., None], 1.0).log_prob(torch.as_tensor(DATA)), dim=-1),
    device="cpu")
LIKS = [("gaussian", 0.3, 3), ("logistic", 0.25, 5)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


def _gp(n, lik, noise, seed):
    return (gp_latent_model(n, likelihood=lik, noise=noise, seed=seed, device="cpu"),
            jax_gp(n, likelihood=lik, noise=noise, seed=seed))


# ---- the GP latent field ----------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 64])
@pytest.mark.parametrize("lik,noise,seed", LIKS)
def test_gp_model_matches_jax(n, lik, noise, seed):
    (pm, pp, pa), (jm, jp, ja) = _gp(n, lik, noise, seed)
    assert sorted(pa) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(pa[k], ja[k])
    np.testing.assert_array_equal(pp.scale_tril.numpy(), np.asarray(jp.scale_tril))
    np.testing.assert_array_equal(pp.loc.numpy(), np.asarray(jp.loc))
    np.testing.assert_array_equal(pm.tile_consts[0].numpy(), jm.tile_consts[0])
    assert pm.dimension == n
    assert pm.cuda_density == {"gaussian": "gp_regression", "logistic": "gp_classification"}[lik]
    rng = np.random.default_rng(n)
    L = np.asarray(jp.scale_tril, np.float64)
    f = (L @ rng.normal(size=(n, 32)) * rng.uniform(0.2, 3.0, size=32)).astype(np.float32)
    jtile = np.asarray(jm.tile_density(jnp.asarray(f), jnp.asarray(jm.tile_consts[0])))
    tol = dict(rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(pm.tile_density(torch.as_tensor(f), *pm.tile_consts).numpy(),
                               jtile, **tol)
    np.testing.assert_allclose(pm.logdensity_batched_fn(torch.as_tensor(f.T)).numpy(),
                               np.asarray(jm.logdensity_batched_fn(jnp.asarray(f.T))), **tol)
    for c in range(4):
        np.testing.assert_allclose(float(pm.logdensity_fn(torch.as_tensor(f[:, c]))),
                                   float(jm.logdensity_fn(jnp.asarray(f[:, c]))), **tol)


def test_gp_unknown_likelihood_raises():
    with pytest.raises(ValueError, match="likelihood"):
        gp_latent_model(8, likelihood="poisson", device="cpu")


# ---- the move on JAX's random numbers -----------------------------------------------


def _jax_ess_draws(key, prior, C, max_shrink):
    """The numbers JAX's ``EllipticalSlice._step_impl`` draws from ``key``
    for one prior leaf and C chains."""
    k_nu, k_y, k_theta, k_shrink = jax.random.split(key, 4)
    (k,) = jax.random.split(k_nu, 1)
    nu = prior.sample(k, (C,))
    e = jax.random.exponential(k_y, (C,))
    theta0 = jax.random.uniform(k_theta, (C,), minval=0.0, maxval=2.0 * math.pi)
    trip_u = jnp.stack([jax.random.uniform(jax.random.fold_in(k_shrink, i), (C,))
                        for i in range(max_shrink)])
    return nu, e, theta0, trip_u


@pytest.mark.parametrize("lik,noise,seed", LIKS)
@pytest.mark.parametrize("max_shrink", [64, 2])
def test_ess_move_matches_jax_on_its_noise(lik, noise, seed, max_shrink):
    (pm, pp, _), (jm, jp, _) = _gp(16, lik, noise, seed)
    C = 64
    rng = np.random.default_rng(max_shrink)
    x = (np.asarray(jp.scale_tril) @ rng.normal(size=(16, C))).T.astype(np.float32)
    lp = np.array(jm.logdensity_batched_fn(jnp.asarray(x)))
    jspl, pspl = ref.EllipticalSlice(jp, max_shrink=max_shrink), EllipticalSlice(pp, max_shrink)
    state = ref.samplers.base.Transition(jnp.asarray(x), jnp.asarray(lp), jnp.zeros(C, bool))
    for i in range(2):
        key = jax.random.fold_in(jax.random.key(11), i)
        nu, e, theta0, trip_u = (torch.as_tensor(np.array(a)) for a in
                                 _jax_ess_draws(key, jp, C, max_shrink))
        want, _ = jspl.step_batched(key, state, jm, (C,))
        got = pspl.ess_move(pm, torch.as_tensor(x), torch.as_tensor(lp), [nu],
                            torch.as_tensor(lp) - e, theta0, trip_u, (C,))
        _close(got.params, want.params)
        _close(got.lp, want.lp)
        np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
        if max_shrink == 2:
            assert not bool(got.accepted.all())  # some lanes exhaust their trips
            stay = ~got.accepted.numpy()
            np.testing.assert_array_equal(got.params.numpy()[stay], x[stay])
        state = want
        x, lp = np.array(want.params), np.array(want.lp)


# ---- tests/test_ess.py on the torch engine ----------------------------------------------


class TestESSTorchEngine:
    def test_conjugate_posterior_moments(self):
        res = sample(LIKELIHOOD, EllipticalSlice(Normal(0.0, 1.0)), 500, key=0, num_chains=256,
                     discard_initial=50)
        draws = res.transitions.params.reshape(-1).numpy()
        assert abs(draws.mean() - POST_MEAN) < 0.02
        np.testing.assert_allclose(draws.var(), POST_VAR, rtol=0.1)

    def test_rejection_free_and_single_chain_step(self):
        res = sample(LIKELIHOOD, EllipticalSlice(Normal(0.0, 1.0)), 200, key=1, num_chains=32)
        assert bool(res.transitions.accepted[:, 1:].all())
        spl = EllipticalSlice(Normal(0.0, 1.0))
        gen = torch.Generator().manual_seed(0)
        t, state = spl.init(gen, LIKELIHOOD)
        t2, _ = spl.step(gen, state, LIKELIHOOD)
        assert t2.params.shape == t.params.shape and bool(t2.accepted)

    def test_constant_likelihood_samples_prior(self):
        cov = np.array([[2.0, 0.8], [0.8, 1.0]], dtype=np.float32)
        prior = MvNormal.from_cov(torch.tensor([1.0, -2.0]), torch.as_tensor(cov))
        flat = DensityModel(lambda th: torch.zeros(()), dimension=2, device="cpu")
        res = sample(flat, EllipticalSlice(prior), 400, key=2, num_chains=256, discard_initial=20)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(draws.mean(0), [1.0, -2.0], atol=0.05)
        np.testing.assert_allclose(np.cov(draws.T), cov, rtol=0.1, atol=0.05)

    def test_dict_params(self):
        prior = {"a": Normal(0.0, 1.0), "b": MvNormal.standard(2, device="cpu")}
        obs_b = torch.tensor([0.5, -0.5])
        model = DensityModel(lambda th: Normal(th["a"], 0.5).log_prob(1.0)
                             + torch.sum(Normal(th["b"], 1.0).log_prob(obs_b)), device="cpu")
        res = sample(model, EllipticalSlice(prior), 400, key=3, num_chains=128,
                     discard_initial=50)
        a = res.transitions.params["a"].reshape(-1).numpy()
        b = res.transitions.params["b"].reshape(-1, 2).numpy()
        assert abs(a.mean() - 0.8) < 0.05
        np.testing.assert_allclose(b.mean(0), [0.25, -0.25], atol=0.05)

    def test_init(self):
        gen = torch.Generator().manual_seed(0)
        spl = EllipticalSlice(MvNormal(torch.tensor([5.0, 5.0]), scale=0.01))
        t, _ = spl.init(gen, DensityModel(lambda th: torch.zeros(()), device="cpu"))
        np.testing.assert_allclose(t.params.numpy(), [5.0, 5.0], atol=0.1)
        t, _ = EllipticalSlice(Normal(0.0, 1.0)).init(gen, LIKELIHOOD, torch.tensor(0.25))
        assert float(t.params) == 0.25

    def test_errors_and_exhaustion(self):
        gen = torch.Generator().manual_seed(0)
        with pytest.raises(TypeError, match="Gaussian prior"):
            EllipticalSlice(InverseGamma(2.0, 3.0)).init(gen, LIKELIHOOD)
        impossible = DensityModel(lambda th: -torch.inf * torch.ones(()), device="cpu")
        spl = EllipticalSlice(Normal(0.0, 1.0), max_shrink=8)
        _, state = spl.init(gen, impossible, torch.tensor(0.5))
        t, _ = spl.step(gen, state, impossible)
        assert float(t.params) == 0.5 and not bool(t.accepted)
        model = DensityModel(lambda x: Normal(0.0, 1.0).log_prob(x["a"]), device="cpu")
        tree = EllipticalSlice({"a": Normal(0.0, 1.0), "b": Normal(0.0, 1.0)})
        with pytest.raises(ValueError, match="leaves"):
            sample(model, tree, 5, key=0, initial_params={"a": torch.zeros(())})

    def test_gp_analytic_posterior(self):
        model, prior, aux = gp_latent_model(32, noise=0.3, seed=3, device="cpu")
        res = sample(model, EllipticalSlice(prior), 600, key=4, num_chains=128,
                     discard_initial=100)
        draws = res.transitions.params.reshape(-1, 32).numpy()
        np.testing.assert_allclose(draws.mean(0), aux["post_mean"], atol=0.05)
        np.testing.assert_allclose(draws.var(0), np.diag(aux["post_cov"]), rtol=0.15,
                                   atol=0.01)

    def test_gp_logistic_runs(self):
        model, prior, aux = gp_latent_model(32, likelihood="logistic", seed=5, device="cpu")
        res = sample(model, EllipticalSlice(prior), 300, key=6, num_chains=64,
                     discard_initial=100)
        draws = res.transitions.params.reshape(-1, 32).numpy()
        assert (np.sign(draws.mean(0)) == aux["y"]).mean() > 0.8


# ---- the fused engine on the plain version ----------------------------------------------


def test_fused_ess_gp_regression():
    """tests/test_pallas.py::test_fused_ess_gp_analytic_posterior at 1024
    chains: the tril prior, starts drawn from the prior."""
    model, prior, aux = gp_latent_model(16, noise=0.3, seed=3, device="cpu")
    res = sample(model, EllipticalSlice(prior), 150, key=11, num_chains=1024, engine="fused",
                 discard_initial=100)
    draws = res.transitions.params.reshape(-1, 16).numpy()
    np.testing.assert_allclose(draws.mean(0), aux["post_mean"], atol=0.03)
    np.testing.assert_allclose(draws.var(0), np.diag(aux["post_cov"]), rtol=0.15, atol=0.01)
    assert float(res.transitions.accepted.float().mean()) > 0.995


def test_fused_ess_diagonal_prior():
    """The diagonal branch (in place of the JAX test's scalar custom
    density, which has no CUDA functor): prior N(0, I) on the GP regression,
    per point the closed form mean y/(1 + σ²), variance σ²/(1 + σ²). The
    likelihood is 11× the prior's precision, so a start drawn from the prior
    takes ~400 steps to forget; the chains start at the posterior mean."""
    model, _, aux = gp_latent_model(16, noise=0.3, seed=3, device="cpu")
    s2 = 0.3 ** 2
    spl = EllipticalSlice(MvNormal(torch.zeros(16), scale_diag=torch.ones(16)))
    res = sample(model, spl, 200, key=3, num_chains=1024, engine="fused", discard_initial=50,
                 initial_params=aux["y"] / (1.0 + s2))
    draws = res.transitions.params.reshape(-1, 16).numpy()
    np.testing.assert_allclose(draws.mean(0), aux["y"] / (1.0 + s2), atol=0.01)
    np.testing.assert_allclose(draws.var(0), s2 / (1.0 + s2), rtol=0.05)


def test_fused_ess_thinning_and_logistic():
    model, prior, aux = gp_latent_model(16, likelihood="logistic", seed=5, device="cpu")
    res = sample(model, EllipticalSlice(prior), 60, key=12, num_chains=1024, engine="fused",
                 discard_initial=60, thinning=3)
    draws = res.transitions.params.reshape(-1, 16).numpy()
    confident = np.abs(aux["f_true"]) > 0.5
    agree = (np.sign(draws.mean(0)[confident]) == np.sign(aux["f_true"][confident])).mean()
    assert agree > 0.95
    assert tuple(res.final_state.params.shape) == (1024, 16)


def test_fused_split_run_is_bit_exact():
    model, prior, _ = gp_latent_model(16, likelihood="logistic", seed=5, device="cpu")
    kw = dict(key=2, num_chains=96, engine="fused", thinning=2)
    whole = sample(model, EllipticalSlice(prior), 30, discard_initial=10, **kw)
    first = sample(model, EllipticalSlice(prior), 12, discard_initial=10, **kw)
    rest = sample(model, EllipticalSlice(prior), 18, discard_initial=2,
                  initial_state=first.final_state, iteration_offset=8 + 24, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))


def test_fused_errors():
    model, prior, _ = gp_latent_model(8, device="cpu")
    tree = EllipticalSlice({"a": prior})
    with pytest.raises(ValueError, match="single Normal/MvNormal"):
        sample(model, tree, 5, key=0, num_chains=4, engine="fused",
               initial_params=torch.zeros(8))
    with pytest.raises(ValueError, match="single Normal/MvNormal"):
        sample(model, EllipticalSlice(InverseGamma(2.0, 3.0)), 5, key=0, num_chains=4,
               engine="fused", initial_params=torch.zeros(8))


def test_convert_gp_model_and_jax_state_resume():
    """``gp_latent_from_numpy`` on JAX's y, L and noise gives a model whose
    density equals JAX's, and a JAX ESS state resumes on the fused engine."""
    jm, jp, ja = jax_gp(16, noise=0.3, seed=3)
    pm, pp = gp_latent_from_numpy(ja["y"], np.asarray(jp.scale_tril), "gaussian", 0.3,
                                  device="cpu")
    f = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    np.testing.assert_allclose(pm.tile_density(torch.as_tensor(f), *pm.tile_consts).numpy(),
                               np.asarray(jm.tile_density(jnp.asarray(f),
                                                          jnp.asarray(jm.tile_consts[0]))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(pp.scale_tril.numpy(), np.asarray(jp.scale_tril))
    res = ref.sample(jm, ref.EllipticalSlice(jp), 20, key=jax.random.key(4), num_chains=64)
    st = res.final_state
    pst = transition_from_numpy(np.asarray(st.params), np.asarray(st.lp),
                                np.asarray(st.accepted), device="cpu")
    out = sample(pm, EllipticalSlice(pp), 30, key=5, num_chains=64, engine="fused",
                 discard_initial=1, initial_state=pst)
    assert bool(torch.isfinite(out.transitions.params).all())
    assert float(out.transitions.accepted.float().mean()) > 0.99
    assert tuple(out.final_state.params.shape) == (64, 16)
