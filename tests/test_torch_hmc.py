"""HamiltonianMC in advancedmh_tpu_torch against advancedmh_tpu: one leapfrog
trajectory and its energy error against the JAX sampler's ``_leapfrog`` and
``_kinetic`` (1e-5), the fused kernel's plain version against the torch
engine step for step on the same noise, the fused engine's validation
errors (tests/test_fused_runtime.py) and tests/test_pallas.py's fused-HMC
checks on the plain version (tests/test_hmc.py's moment tests are in
tests/test_torch_hmc_moments.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models.targets import correlated_gaussian_model as ref_corr
from advancedmh_tpu.models.targets import logistic_regression_model as ref_logreg
from advancedmh_tpu_torch import DensityModel, HamiltonianMC, sample
from advancedmh_tpu_torch.convert import (
    correlated_gaussian_from_numpy,
    gaussian_mean_scale_from_numpy,
    logistic_regression_from_numpy,
)
from advancedmh_tpu_torch.models import logistic_regression_model
from advancedmh_tpu_torch.ops import fused_hmc_sample, hmc_sample_reference, minv_column
from advancedmh_tpu_torch.ops.hmc import hmc_step
from advancedmh_tpu_torch.ops.common import step_noise

COV = np.asarray([[1.5, 0.35], [0.35, 1.0]], np.float32)
MODEL = gaussian_mean_scale_from_numpy(np.random.default_rng(1234).normal(size=300),
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
    return torch.as_tensor(np.asarray(a, np.float32))


def _corr(cov=COV):
    return correlated_gaussian_from_numpy(cov, device="cpu")


# ---- one trajectory against the JAX sampler ----------------------------------


@pytest.mark.parametrize("target", ["corr", "logreg"])
@pytest.mark.parametrize("minv", [None, "diag"])
def test_leapfrog_and_energy_match_jax(target, minv):
    rng = np.random.default_rng(11)
    if target == "corr":
        port, jm = _corr(), ref_corr(COV)
        d = 2
    else:
        jm = ref_logreg(64, 8, seed=4)
        port = logistic_regression_from_numpy(np.asarray(jm.tile_consts[0]),
                                              np.asarray(jm.tile_consts[1])[:, 0],
                                              device="cpu")
        d = 8
    m = None if minv is None else rng.uniform(0.5, 2.0, size=d).astype(np.float32)
    x = rng.normal(size=d).astype(np.float32)
    p0 = rng.normal(size=d).astype(np.float32)
    spl_j = ref.HamiltonianMC(0.15, 7, inverse_mass=None if m is None else jnp.asarray(m))
    spl_p = HamiltonianMC(0.15, 7, inverse_mass=None if m is None else _t(m))
    lp_j, g_j = jm.logdensity_and_gradient_fn(jnp.asarray(x))
    want = spl_j._leapfrog(jm, jnp.asarray(x), jnp.asarray(p0), lp_j, g_j)
    lp_p, g_p = port.logdensity_and_gradient_fn(_t(x))
    got = spl_p._trajectory(port.logdensity_and_gradient_fn, _t(x), _t(p0), lp_p, g_p)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    dh_j = (want[2] - spl_j._kinetic(want[1], want[0])) - (lp_j - spl_j._kinetic(jnp.asarray(p0), jnp.asarray(x)))
    dh_p = (got[2] - spl_p._kinetic(got[1], got[0])) - (lp_p - spl_p._kinetic(_t(p0), _t(x)))
    np.testing.assert_allclose(float(dh_p), float(dh_j), rtol=1e-5, atol=1e-5)

    # the kernel's plain step on the same trajectory: z = p0·√M⁻¹ gives p0,
    # and log u = −∞ accepts, so it must land on the trajectory's end
    mcol = minv_column(None if m is None else _t(m), d, "cpu")
    z = _t(p0)[:, None] * torch.sqrt(mcol)
    lp_t, g_t = port.tile_value_and_grad(_t(x)[:, None], *port.tile_consts)
    y, lp_y, g_y, acc = hmc_step(_t(x)[:, None], lp_t, g_t, z, torch.full((1,), -np.inf),
                                 0.15, mcol, 7, port.tile_value_and_grad, port.tile_consts)
    assert bool(acc.all())
    np.testing.assert_allclose(y[:, 0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(lp_y), float(want[2]), rtol=1e-5, atol=1e-5)


# ---- the plain kernel version against the torch engine -------------------------


@pytest.mark.parametrize("target", ["flagship", "corr"])
def test_plain_version_matches_torch_engine_step_for_step(target):
    """The same normals and uniforms through ops/hmc.py's plain version and
    through HamiltonianMC.step_from_noise (e = −log u): states, lp and the
    gradient within 1e-5, every decision equal."""
    m = MODEL if target == "flagship" else _corr()
    C, n, d = 64, 12, 2
    rng = np.random.default_rng(5)
    start = np.stack([rng.normal(0.0, 0.1, C), rng.uniform(0.8, 1.2, C)]) \
        if target == "flagship" else rng.normal(size=(2, C))
    x0 = _t(start)
    minv = _t([0.8, 1.3])
    lp0, g0 = m.tile_value_and_grad(x0, *m.tile_consts)
    args = (m.tile_value_and_grad, m.cuda_density, x0, lp0, g0, m.tile_consts, 99)
    kw = dict(step_size=0.04 if target == "flagship" else 0.3, n_leapfrog=5,
              inverse_mass=minv_column(minv, d, "cpu"), burn=0, thin=1, n_samples=n,
              iteration_offset=3)
    samples, lps, accs, g_last = fused_hmc_sample(*args, **kw)
    ref_out = hmc_sample_reference(*args, **kw)
    for a, b in zip((samples, lps, accs, g_last), ref_out):
        assert torch.equal(a, b)  # the wrapper runs the plain version on CPU

    spl = HamiltonianMC(kw["step_size"], 5, inverse_mass=minv)
    z, logu = step_noise(99, 4, n, C, d, "cpu")
    state, _ = spl.init_batched(None, m, (C,), x0.T.contiguous(), True)
    for t in range(n):
        state, _ = spl.step_from_noise(state, m, z[t].T, -logu[t], (C,))
        assert torch.equal(state.accepted, accs[t, 0] > 0.5)
        np.testing.assert_allclose(state.params.numpy(), samples[t].T.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(state.lp.numpy(), lps[t, 0].numpy(), rtol=1e-5, atol=1e-5)
    # the flagship's σ component is a difference of two sums of ~n·σ that
    # nearly cancel: its error is held at 1e-3 absolute (terms ~300)
    np.testing.assert_allclose(state.gradient.numpy(), g_last.T.numpy(), rtol=1e-4, atol=1e-3)


def test_plain_version_thinning_and_offset_are_one_run():
    """burn/thin select steps of one run: a thinned run's draws are steps
    of the unthinned run, and a run split at any step and resumed at its
    offset is bit-exact."""
    m = _corr()
    x0 = _t(np.random.default_rng(1).normal(size=(2, 40)))
    lp0, g0 = m.tile_value_and_grad(x0, *m.tile_consts)
    mcol = minv_column(None, 2, "cpu")
    base = (m.tile_value_and_grad, m.cuda_density)
    kw = dict(step_size=0.3, n_leapfrog=4, inverse_mass=mcol)
    full = hmc_sample_reference(*base, x0, lp0, g0, m.tile_consts, 7, burn=0, thin=1,
                                n_samples=12, **kw)
    thin = hmc_sample_reference(*base, x0, lp0, g0, m.tile_consts, 7, burn=2, thin=3,
                                n_samples=3, **kw)
    assert torch.equal(thin[0], full[0][[4, 7, 10]])
    half = hmc_sample_reference(*base, x0, lp0, g0, m.tile_consts, 7, burn=0, thin=1,
                                n_samples=5, **kw)
    rest = hmc_sample_reference(*base, half[0][-1], half[1][-1], half[3], m.tile_consts, 7,
                                burn=0, thin=1, n_samples=7, iteration_offset=5, **kw)
    assert torch.equal(torch.cat([half[0], rest[0]]), full[0])
    assert torch.equal(rest[3], full[3])


# ---- the fused engine -----------------------------------------------------------


class TestFusedValidation:
    """tests/test_fused_runtime.py's HMC guards: they raise before a launch."""

    def test_multinomial_rejected(self):
        spl = HamiltonianMC(0.3, 5, trajectory_sampling="multinomial")
        with pytest.raises(ValueError, match="endpoint-only"):
            sample(_corr(np.eye(2)), spl, 10, key=0, num_chains=1024, engine="fused",
                   initial_params=torch.zeros(2))

    def test_pytree_mass_and_missing_params_rejected(self):
        spl = HamiltonianMC(0.3, 5, inverse_mass={"a": torch.ones(2)})
        with pytest.raises(ValueError, match="scalar/diagonal"):
            sample(_corr(np.eye(2)), spl, 10, key=0, num_chains=8, engine="fused",
                   initial_params=torch.zeros(2))
        with pytest.raises(ValueError, match="initial parameters"):
            sample(_corr(np.eye(2)), HamiltonianMC(0.3, 5), 10, key=0, num_chains=8,
                   engine="fused")
        with pytest.raises(ValueError, match="tile_value_and_grad"):
            sample(DensityModel(lambda x: -0.5 * torch.sum(x * x), dimension=2, device="cpu"),
                   HamiltonianMC(0.3, 5), 10, key=0, num_chains=8, engine="fused",
                   initial_params=torch.zeros(2))

    def test_wrapper_checks_its_arguments(self):
        m = _corr()
        x = torch.zeros(2, 8)
        lp, g = m.tile_value_and_grad(x, *m.tile_consts)
        args = (m.tile_value_and_grad, m.cuda_density, x, lp, g, m.tile_consts, 1)
        kw = dict(step_size=0.1, n_leapfrog=3, burn=0, thin=1, n_samples=2)
        with pytest.raises(ValueError, match=r"\(2, 1\) column"):
            fused_hmc_sample(*args, inverse_mass=torch.ones(2), **kw)
        with pytest.raises(ValueError, match="n_leapfrog"):
            fused_hmc_sample(*args, inverse_mass=minv_column(None, 2, "cpu"),
                             **{**kw, "n_leapfrog": 0})
        with pytest.raises(ValueError, match="scalar or length 2"):
            minv_column(torch.ones(3), 2, "cpu")


def test_fused_hmc_on_the_plain_version():
    """tests/test_pallas.py::TestFusedHMC at 256 chains: covariance recovery
    and the final gradient against −P·x."""
    res = sample(_corr(), HamiltonianMC(0.4, 8), 300, key=21, num_chains=256, engine="fused",
                 discard_initial=100, initial_params=torch.ones(2))
    draws = res.transitions.params.reshape(-1, 2).numpy()
    assert float(res.transitions.accepted.float().mean()) > 0.8
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.05)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.1)
    x = res.final_state.params.numpy()
    np.testing.assert_allclose(res.final_state.gradient.numpy(),
                               -(np.linalg.inv(COV) @ x.T).T, rtol=1e-3, atol=1e-3)


def test_fused_hmc_thinning_and_mass_on_the_plain_version():
    res = sample(_corr(np.diag([9.0, 1.0])),
                 HamiltonianMC(0.5, 6, inverse_mass=torch.tensor([9.0, 1.0])), 150, key=22,
                 num_chains=256, engine="fused", discard_initial=60, thinning=3,
                 initial_params=torch.zeros(2))
    assert tuple(res.transitions.params.shape) == (256, 150, 2)
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.15)
    np.testing.assert_allclose(draws.var(0), [9.0, 1.0], rtol=0.1)


def test_fused_hmc_logistic_regression_small():
    """The d = 8 logistic regression through sample(engine='fused') on the
    plain version: finite draws whose means sit near the engine='torch'
    run's."""
    m = logistic_regression_model(64, 8, seed=2, device="cpu")
    kw = dict(key=9, num_chains=64, discard_initial=60, initial_params=torch.zeros(8))
    fused = sample(m, HamiltonianMC(0.1, 8), 120, engine="fused", **kw)
    torch_run = sample(m, HamiltonianMC(0.1, 8), 120, **kw)
    a = fused.transitions.params.reshape(-1, 8).numpy()
    b = torch_run.transitions.params.reshape(-1, 8).numpy()
    assert np.isfinite(a).all()
    assert np.abs(a.mean(0) - b.mean(0)).max() < 0.35 * b.std(0).max()
