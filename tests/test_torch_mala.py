"""MALA in advancedmh_tpu_torch against advancedmh_tpu: tests/test_mala.py's
cases on the torch engine, one step's logα against the JAX package's
proposal densities, and the fused kernel's plain version at
tests/test_pallas.py's tolerances.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.proposals import q as ref_q
from advancedmh_tpu.samplers.mala import _resolve_tree as ref_resolve
from advancedmh_tpu_torch import (
    MALA,
    DensityModel,
    GradientTransition,
    MvNormal,
    getparams,
    sample,
    setparams,
)
from advancedmh_tpu_torch.convert import (
    correlated_gaussian_from_numpy,
    gaussian_mean_scale_from_numpy,
    gradient_transition_from_numpy,
)
from advancedmh_tpu_torch.models import as_model
from advancedmh_tpu_torch.ops import fused_mala_sample
from advancedmh_tpu_torch.ops.mala import mala_constants, mala_logalpha
from advancedmh_tpu_torch.utils import generator

MODEL = gaussian_mean_scale_from_numpy(np.random.default_rng(1234).normal(size=300),
                                       device="cpu")
SIGMA2 = 1e-3
SPL = MALA(lambda g: MvNormal(SIGMA2 / 2.0 * g, scale=math.sqrt(SIGMA2)))
SIG = np.array([[1.5, 0.35], [0.35, 1.0]], dtype=np.float32)
A = np.linalg.inv(SIG).astype(np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quadratic_model():
    At = torch.as_tensor(A)
    return DensityModel(lambda x: -x @ At @ x / 2.0,
                        logdensity_and_gradient_fn=lambda x: (-x @ At @ x / 2.0, -At @ x),
                        dimension=2, device="cpu")


# ---- tests/test_mala.py on the torch engine ------------------------------------


def test_requires_initial_params():
    with pytest.raises(ValueError, match="initial parameters"):
        sample(MODEL, SPL, 100, key=0, discard_initial=10)


def test_posterior_moments():
    chains = sample(MODEL, SPL, 2000, key=1, num_chains=16, initial_params=[1.0, 1.0],
                    discard_initial=500, chain_type="chains", param_names=["μ", "σ"])
    assert abs(float(chains["μ"].mean())) < 0.1
    assert abs(float(chains["σ"].mean()) - 1.0) < 0.1


def test_object_without_gradient_is_order_zero():
    """≙ check_capabilities (src/MALA.jl:42-52)."""
    class Target:
        dimension = 2

        def logdensity(self, x):
            return -0.5 * torch.sum(x * x)

    m = as_model(Target(), device="cpu")
    assert m.capabilities == 0
    with pytest.raises(ValueError, match="gradient"):
        sample(m, SPL, 5, key=0, initial_params=[0.0, 0.0])


def test_gradient_cached_in_transition():
    _, state = SPL.init(generator(0, "cpu"), MODEL, torch.ones(2))
    assert isinstance(state, GradientTransition)
    _, s2 = SPL.step(generator(1, "cpu"), state, MODEL)
    assert tuple(s2.gradient.shape) == (2,)


def test_getparams_setparams():
    t, _ = SPL.init(generator(0, "cpu"), MODEL, torch.ones(2))
    assert torch.equal(getparams(t), t.params)
    same = setparams(MODEL, t, getparams(t))
    assert float(same.lp) == float(t.lp)
    np.testing.assert_allclose(same.gradient.numpy(), t.gradient.numpy(), rtol=1e-6)
    new = setparams(MODEL, t, torch.tensor([1.0, 2.0]))
    assert float(new.lp) == pytest.approx(float(MODEL.logdensity_fn(torch.tensor([1.0, 2.0]))),
                                          rel=1e-5)


def test_covariance_recovery():
    """≙ the reference's MALA test on N(0, Σ) (test/runtests.jl:317-364),
    with an analytic gradient."""
    spl = MALA(lambda g: MvNormal(0.25 * g, scale=math.sqrt(0.5)))
    res = sample(_quadratic_model(), spl, 1500, key=2, num_chains=64,
                 initial_params=[1.0, 1.0], discard_initial=500)
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.1)
    np.testing.assert_allclose(np.cov(draws.T), SIG, atol=0.2)


def test_analytic_gradient_used():
    calls = []
    At = torch.as_tensor(A)

    def ldg(x):
        calls.append(1)
        return -x @ At @ x / 2.0, -At @ x

    m = DensityModel(lambda x: -x @ At @ x / 2.0, logdensity_and_gradient_fn=ldg,
                     dimension=2, device="cpu")
    MALA(lambda g: MvNormal(0.25 * g, scale=math.sqrt(0.5))).init(
        generator(0, "cpu"), m, torch.ones(2))
    assert calls


def test_langevin_records_step_size():
    spl = MALA.langevin(0.02)
    assert spl.langevin_step_size_sq == 0.02
    assert MALA(lambda g: MvNormal(g, scale=1.0)).langevin_step_size_sq is None


# ---- one step's logα against the JAX package's proposal densities -----------------


@pytest.mark.parametrize("s2", [0.02, 0.5])
def test_step_logalpha_matches_jax_q(s2):
    """The kernel's logα (plain version) on identical (x, g, y, g_y) against
    lp_y − lp + log q(x|y) − log q(y|x) from JAX's ``proposals.q`` with
    ``MALA.langevin`` (atol 1e-5: the constants of the two Gaussian
    densities cancel in float32)."""
    rng = np.random.default_rng(int(s2 * 100))
    d, C = 2, 16
    x, g, y, g_y = (rng.normal(size=(d, C)).astype(np.float32) for _ in range(4))
    lp, lp_y = (rng.normal(-5, 2, size=(1, C)).astype(np.float32) for _ in range(2))
    _, half_s2, inv_2s2 = mala_constants(s2)
    got = mala_logalpha(*(torch.as_tensor(a) for a in (x, lp, g, y, lp_y, g_y)),
                        half_s2, inv_2s2).numpy()[0]
    spl = ref.MALA.langevin(s2)
    for c in range(C):
        fwd = ref_resolve(spl.proposal, jnp.asarray(g[:, c]))
        bwd = ref_resolve(spl.proposal, jnp.asarray(g_y[:, c]))
        want = (lp_y[0, c] - lp[0, c] + ref_q(bwd, jnp.asarray(x[:, c]), jnp.asarray(y[:, c]))
                - ref_q(fwd, jnp.asarray(y[:, c]), jnp.asarray(x[:, c])))
        np.testing.assert_allclose(got[c], float(want), rtol=1e-5, atol=1e-5)


# ---- the fused kernel's plain version --------------------------------------------


def test_fused_plain_correlated_gaussian():
    """tests/test_pallas.py::test_sample_engine_fused_mala's tolerances: mean
    ±0.05, covariance atol 0.1, the final gradient −P·x at 1e-3."""
    model = correlated_gaussian_from_numpy(SIG, device="cpu")
    res = sample(model, MALA.langevin(0.5), 1500, key=6, num_chains=512, engine="fused",
                 discard_initial=500, initial_params=[1.0, 1.0])
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.05)
    np.testing.assert_allclose(np.cov(draws.T), SIG, atol=0.1)
    x = res.final_state.params.numpy()
    np.testing.assert_allclose(res.final_state.gradient.numpy(), -(A @ x.T).T,
                               rtol=1e-3, atol=1e-3)
    assert torch.equal(res.final_state.params, res.transitions.params[:, -1])


def test_fused_plain_flagship_matches_torch_engine():
    model = gaussian_mean_scale_from_numpy(np.random.default_rng(1234).normal(size=30),
                                           device="cpu")
    kw = dict(num_chains=256, discard_initial=300, initial_params=[0.0, 1.0],
              chain_type="chains", param_names=["μ", "σ"])
    fused = sample(model, MALA.langevin(0.02), 1000, key=3, engine="fused", **kw)
    torch_ = sample(model, MALA.langevin(0.02), 1000, key=4, **kw)
    for name in ("μ", "σ"):
        assert abs(float(fused[name].mean()) - float(torch_[name].mean())) < 0.05


def test_fused_split_run_is_bit_identical():
    model = correlated_gaussian_from_numpy(SIG, device="cpu")
    kw = dict(key=5, num_chains=6, engine="fused", discard_initial=1)
    whole = sample(model, MALA.langevin(0.5), 24, initial_params=[1.0, 1.0], **kw)
    first = sample(model, MALA.langevin(0.5), 12, initial_params=[1.0, 1.0], **kw)
    second = sample(model, MALA.langevin(0.5), 12, initial_state=first.final_state,
                    iteration_offset=12, **kw)
    joined = torch.cat([first.transitions.params, second.transitions.params], dim=1)
    assert torch.equal(joined, whole.transitions.params)


def test_fused_needs_langevin_and_a_gradient():
    model = correlated_gaussian_from_numpy(SIG, device="cpu")
    with pytest.raises(ValueError, match="langevin"):
        sample(model, SPL, 5, num_chains=4, engine="fused", initial_params=[0.0, 0.0])
    with pytest.raises(ValueError, match="initial parameters"):
        sample(model, MALA.langevin(0.1), 5, num_chains=4, engine="fused")
    with pytest.raises(ValueError, match="tile_value_and_grad"):
        sample(_quadratic_model(), MALA.langevin(0.1), 5, num_chains=4, engine="fused",
               initial_params=[0.0, 0.0])


def test_fused_wrapper_plain_on_cpu_tensors():
    """On CPU tensors the wrapper runs the plain version: no launch."""
    model = correlated_gaussian_from_numpy(SIG, device="cpu")
    st = gradient_transition_from_numpy(np.zeros((2, 8)), np.zeros((1, 8)),
                                        np.zeros((2, 8)), np.zeros(8), device="cpu")
    fused_mala_sample.launches = 0
    out = fused_mala_sample(model.tile_value_and_grad, model.cuda_density, st.params,
                            *model.tile_value_and_grad(st.params, *model.tile_consts),
                            model.tile_consts, 1, step_size_sq=0.5, burn=2, thin=2,
                            n_samples=3)
    assert [tuple(t.shape) for t in out] == [(3, 2, 8), (3, 1, 8), (3, 1, 8), (2, 8)]
    assert fused_mala_sample.launches == 0
