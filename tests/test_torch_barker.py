"""The Barker proposal in advancedmh_tpu_torch against advancedmh_tpu.

- ``Barker._propose`` and ``_logratio`` on JAX's normals and uniforms (1e-6),
  and ``step_from_noise`` against JAX's ``step_batched`` on its own random
  numbers (1e-5, decisions equal), array and dict params;
- tests/test_barker.py's assertions on the torch engine, at their
  tolerances (more chains, fewer steps);
- the fused engine on its plain version (tests/test_pallas.py's Barker
  check at 1024 chains: covariance, acceptance band, the final gradient
  −Σ⁻¹x), a split run bit for bit, and the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models.targets import correlated_gaussian_model as jax_corr
from advancedmh_tpu.models.targets import gaussian_mean_scale_model as jax_flagship
from advancedmh_tpu_torch import (MALA, Barker, DensityModel, MvNormal, Normal,
                                  StepSizeAdaptation, sample)
from advancedmh_tpu_torch.convert import (correlated_gaussian_from_numpy,
                                          gradient_transition_from_numpy)
from advancedmh_tpu_torch.models import gaussian_mean_scale_model
from advancedmh_tpu_torch.utils.tree import tree_flatten

SIG = np.array([[1.5, 0.35], [0.35, 1.0]], dtype=np.float32)
P = np.linalg.inv(SIG).astype(np.float32)
MODEL = gaussian_mean_scale_model(data=np.random.default_rng(1234).normal(size=300),
                                  device="cpu")


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


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


def _jax_tree_randoms(key, tree, draw):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten([draw(k, jnp.shape(leaf)) for k, leaf in zip(keys, leaves)])


def _jax_noise(key, params):
    """The normals and uniforms JAX's ``Barker._propose`` draws from ``key``."""
    key_z, key_b = jax.random.split(key)
    return (_jax_tree_randoms(key_z, params, jax.random.normal),
            _jax_tree_randoms(key_b, params, jax.random.uniform))


def test_propose_and_logratio_match_jax():
    rng = np.random.default_rng(0)
    for params in (rng.normal(size=(64, 3)).astype(np.float32),
                   {"a": rng.normal(size=64).astype(np.float32),
                    "b": rng.normal(size=(64, 2)).astype(np.float32)}):
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        g = jax.tree_util.tree_map(lambda x: 3.0 * jnp.asarray(rng.normal(size=x.shape),
                                                               jnp.float32), jp)
        key = jax.random.key(7)
        z, u = _jax_noise(key, jp)
        to_t = lambda tree: jax.tree_util.tree_map(_t, tree)
        want = ref.Barker(0.7)._propose(key, jp, g)
        got = Barker(0.7)._propose(to_t(z), to_t(u), to_t(g))
        for a, b in zip(tree_flatten(got)[0], jax.tree_util.tree_leaves(want)):
            _close(a, b, 1e-6)
        gy = jax.tree_util.tree_map(lambda x: -x, g)
        _close(Barker._logratio(got, to_t(g), to_t(gy), batch_ndim=1),
               ref.Barker._logratio(want, g, gy, batch_ndim=1), 1e-6)


@pytest.mark.parametrize("target", ["flagship", "corr"])
def test_step_matches_jax_on_its_noise(target):
    C = 64
    rng = np.random.default_rng(1)
    if target == "flagship":
        jm, pm, eps = jax_flagship(), gaussian_mean_scale_model(device="cpu"), 0.1
        x = np.stack([rng.normal(0.0, 0.3, C), rng.uniform(0.6, 2.0, C)], 1).astype(np.float32)
    else:
        jm, pm, eps = jax_corr(SIG), correlated_gaussian_from_numpy(SIG, device="cpu"), 0.9
        x = rng.normal(size=(C, 2)).astype(np.float32)
    ldg = jm.logdensity_and_gradient_fn or jax.value_and_grad(jm.logdensity_fn)
    lp, g = jax.vmap(ldg)(jnp.asarray(x))
    jst = ref.samplers.base.GradientTransition(jnp.asarray(x), lp, g, jnp.zeros(C, bool))
    pst = gradient_transition_from_numpy(x, np.array(lp), np.array(g), np.zeros(C, bool),
                                         device="cpu")
    for i in range(3):
        key = jax.random.fold_in(jax.random.key(2), i)
        key_prop, key_acc = jax.random.split(key)
        z, u = _jax_noise(key_prop, jst.params)
        e = jax.random.exponential(key_acc, (C,))
        jst, _ = ref.Barker(eps).step_batched(key, jst, jm, (C,))
        pst, _ = Barker(eps).step_from_noise(pst, pm, (C,), _t(z), _t(u), _t(e))
        np.testing.assert_array_equal(pst.accepted.numpy(), np.asarray(jst.accepted))
        for f in ("params", "lp", "gradient"):
            _close(getattr(pst, f), getattr(jst, f), 1e-5)


# ---- tests/test_barker.py on the torch engine -------------------------------------------


def _quadratic_model():
    Pt = torch.as_tensor(P)
    return DensityModel(lambda x: -0.5 * x @ Pt @ x,
                        logdensity_and_gradient_fn=lambda x: (-0.5 * x @ Pt @ x, -Pt @ x),
                        dimension=2, device="cpu")


class TestBarkerTorchEngine:
    def test_requires_initial_params_and_caches_gradient(self):
        with pytest.raises(ValueError, match="initial parameters"):
            sample(MODEL, Barker(0.1), 100, key=0)
        _, state = Barker(0.5).init(torch.Generator(), MODEL, torch.tensor([0.0, 1.0]))
        x = torch.tensor([0.0, 1.0], requires_grad=True)
        MODEL.logdensity_fn(x).backward()
        np.testing.assert_allclose(state.gradient.numpy(), x.grad.numpy(), rtol=1e-6)

    def test_posterior_moments(self):
        chains = sample(MODEL, Barker(step_size=0.05), 500, key=1, num_chains=64,
                        initial_params=torch.ones(2), discard_initial=500, chain_type="chains",
                        param_names=["μ", "σ"])
        assert abs(float(chains["μ"].mean())) < 0.1
        assert abs(float(chains["σ"].mean()) - 1.0) < 0.1

    def test_covariance_recovery(self):
        res = sample(_quadratic_model(), Barker(step_size=0.9), 800, key=2, num_chains=256,
                     initial_params=torch.ones(2), discard_initial=300)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.05)
        np.testing.assert_allclose(np.cov(draws.T), SIG, atol=0.15)

    def test_survives_step_sizes_that_kill_mala(self):
        sigma = 4.0
        model = DensityModel(lambda x: -0.5 * torch.sum(x * x), dimension=2, device="cpu")
        kw = dict(key=3, num_chains=128, initial_params=torch.zeros(2), discard_initial=100)
        res_b = sample(model, Barker(step_size=sigma), 400, **kw)
        res_m = sample(model, MALA(lambda g: MvNormal(sigma ** 2 / 2.0 * g, scale=sigma)), 400,
                       **kw)
        assert float(res_m.transitions.accepted.float().mean()) < 0.05
        assert float(res_b.transitions.accepted.float().mean()) > 0.15
        draws = res_b.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.1)
        np.testing.assert_allclose(draws.std(0), np.ones(2), atol=0.1)

    def test_dict_params_decorrelated_leaves(self):
        model = DensityModel(lambda x: Normal(1.0, 0.5).log_prob(x["a"])
                             + Normal(-1.0, 0.5).log_prob(x["b"]), device="cpu")
        res = sample(model, Barker(step_size=0.6), 600, key=4, num_chains=256,
                     initial_params={"a": torch.zeros(()), "b": torch.zeros(())},
                     discard_initial=200)
        a = res.transitions.params["a"].reshape(-1).numpy()
        b = res.transitions.params["b"].reshape(-1).numpy()
        np.testing.assert_allclose(a.mean(), 1.0, atol=0.05)
        np.testing.assert_allclose(b.mean(), -1.0, atol=0.05)
        assert abs(np.corrcoef(a, b)[0, 1]) < 0.1

    def test_single_chain_matches_batched(self):
        model = DensityModel(lambda x: -0.5 * torch.sum((x - 2.0) ** 2), dimension=2,
                             device="cpu")
        kw = dict(initial_params=torch.zeros(2), discard_initial=200)
        res_v = sample(model, Barker(step_size=1.0), 600, key=5, num_chains=128, **kw)
        res_s = sample(model, Barker(step_size=1.0), 1200, key=6, num_chains=6,
                       chain_method="sequential", **kw)
        for r in (res_v, res_s):
            m = r.transitions.params.reshape(-1, 2).numpy().mean(0)
            np.testing.assert_allclose(m, [2.0, 2.0], atol=0.05)


# ---- the fused engine on the plain version ----------------------------------------------


def test_fused_barker_correlated_gaussian():
    """tests/test_pallas.py::test_sample_engine_fused_barker at 1024 chains."""
    model = correlated_gaussian_from_numpy(SIG, device="cpu")
    res = sample(model, Barker(step_size=0.9), 400, key=13, num_chains=1024, engine="fused",
                 discard_initial=300, initial_params=torch.ones(2))
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.05)
    np.testing.assert_allclose(np.cov(draws.T), SIG, atol=0.1)
    assert 0.3 < float(res.transitions.accepted.float().mean()) < 0.9
    x = res.final_state.params.numpy()
    np.testing.assert_allclose(res.final_state.gradient.numpy(), -(P @ x.T).T, rtol=1e-3,
                               atol=1e-3)


def test_fused_split_run_is_bit_exact():
    model = gaussian_mean_scale_model(device="cpu")
    kw = dict(key=3, num_chains=100, engine="fused", thinning=3,
              initial_params=torch.tensor([0.0, 1.0]))
    whole = sample(model, Barker(0.1), 20, discard_initial=6, **kw)
    first = sample(model, Barker(0.1), 8, discard_initial=6, **kw)
    rest = sample(model, Barker(0.1), 12, discard_initial=3, initial_state=first.final_state,
                  iteration_offset=3 + 24, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))
    assert torch.equal(rest.final_state.gradient, whole.final_state.gradient)


def test_fused_errors():
    flag = gaussian_mean_scale_model(device="cpu")
    with pytest.raises(ValueError, match="initial parameters"):
        sample(flag, Barker(0.1), 10, key=0, num_chains=8, engine="fused")
    with pytest.raises(ValueError, match="StepSizeAdaptation.rwmh"):
        sample(flag, StepSizeAdaptation.barker(), 10, key=0, num_chains=8, engine="fused",
               num_warmup=5, discard_initial=5, initial_params=torch.tensor([0.0, 1.0]))
