"""Robust Adaptive Metropolis in advancedmh_tpu_torch against advancedmh_tpu:
the rank-1 Cholesky update, RAM's adaptation steps, the torch engine at
tests/test_ram.py's tolerances, and the fused kernel's plain version.

Deterministic pieces (the sweep, ``_adapt``, ``_adapt_pooled``) get the same
numpy inputs in both packages and agree at 1e-5 (float32, sums in another
order). Sampling runs are held to the statistical tolerances of the JAX
package's own tests.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.ops import cholesky as ref_chol
from advancedmh_tpu.samplers.ram import RobustAdaptiveMetropolisState as RefState
from advancedmh_tpu_torch import RobustAdaptiveMetropolis, sample
from advancedmh_tpu_torch.convert import (
    correlated_gaussian_from_numpy,
    gaussian_mean_scale_from_numpy,
    ram_state_from_numpy,
)
from advancedmh_tpu_torch.ops import chol_rank1_update, chol_rank1_update_batched
from advancedmh_tpu_torch.ops.ram import RamParams, fused_ram_sample, ram_step
from advancedmh_tpu_torch.ops.rwmh import step_noise

SIG = np.array([[1.0, 0.5], [0.5, 1.0]])


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _spd(rng, d, batch=()):
    a = rng.normal(size=batch + (d, d))
    return a @ np.swapaxes(a, -1, -2) + d * np.eye(d)


# ---- the rank-1 sweep ------------------------------------------------------


@pytest.mark.parametrize("d", range(1, 9))
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_chol_rank1_update_matches_jax(d, sign):
    rng = np.random.default_rng(d)
    A = _spd(rng, d)
    L = np.linalg.cholesky(A).astype(np.float32)
    v = (0.3 * rng.normal(size=d)).astype(np.float32)
    got, ok = chol_rank1_update(_t(L), _t(v), sign)
    want, want_ok = ref_chol.chol_rank1_update(jnp.asarray(L), jnp.asarray(v),
                                               jnp.asarray(sign, jnp.float32))
    assert bool(ok) and bool(want_ok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy() @ got.numpy().T, A + sign * np.outer(v, v),
                               rtol=2e-4, atol=2e-4)
    assert np.all(np.triu(got.numpy(), 1) == 0.0)


def test_failed_downdate_flags_not_ok_in_both():
    L, v = np.eye(2, dtype=np.float32), np.array([2.0, 0.0], np.float32)
    _, ok = chol_rank1_update(_t(L), _t(v), -1.0)
    _, want_ok = ref_chol.chol_rank1_update(jnp.asarray(L), jnp.asarray(v), jnp.asarray(-1.0))
    assert not bool(ok) and not bool(want_ok)


def test_chol_rank1_update_batched_matches_jax():
    rng = np.random.default_rng(0)
    B, d = 6, 4
    L = np.linalg.cholesky(_spd(rng, d, (B,))).astype(np.float32)
    v = (0.2 * rng.normal(size=(B, d))).astype(np.float32)
    signs = np.array([1, -1, 1, -1, 0, 1], np.float32)
    got, ok = chol_rank1_update_batched(_t(L), _t(v), _t(signs))
    want, want_ok = ref_chol.chol_rank1_update_batched(
        jnp.asarray(L), jnp.asarray(v), jnp.asarray(signs))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---- the adaptation steps -----------------------------------------------------


def _states(x, lp, S, it):
    C = x.shape[0]
    z = np.zeros(C, np.float32)
    port = ram_state_from_numpy(x, lp, S, z, z, it, np.ones(C, bool), device="cpu")
    want = RefState(x=jnp.asarray(x), logprob=jnp.asarray(lp), S=jnp.asarray(S),
                    logalpha=jnp.asarray(z), eta=jnp.asarray(z),
                    iteration=jnp.asarray(np.asarray(it, np.int32)),
                    isaccept=jnp.ones(C, bool))
    return port, want


@pytest.mark.parametrize("d,logalpha,it", [(2, -0.3, 1), (3, -2.5, 17), (4, 0.0, 250)])
def test_adapt_matches_jax(d, logalpha, it):
    rng = np.random.default_rng(d)
    S = np.linalg.cholesky(_spd(rng, d)).astype(np.float32)
    U = rng.normal(size=d).astype(np.float32)
    port_state, ref_state = _states(np.zeros((1, d), np.float32), np.zeros(1, np.float32),
                                    S[None], [it])
    one = lambda s: type(s)(**{k: getattr(s, k)[0] for k in s.__dataclass_fields__})  # noqa: E731
    spl, rspl = RobustAdaptiveMetropolis(), ref.RobustAdaptiveMetropolis()
    S_new, eta, ok = spl._adapt(one(port_state), _t(logalpha), _t(U))
    want_S, want_eta, want_ok = rspl._adapt(
        RefState(**{k: getattr(ref_state, k)[0] for k in ref_state.__dataclass_fields__}),
        jnp.asarray(logalpha, jnp.float32), jnp.asarray(U))
    assert bool(ok) == bool(want_ok)
    np.testing.assert_allclose(float(eta), float(want_eta), rtol=1e-6)
    np.testing.assert_allclose(S_new.numpy(), np.asarray(want_S), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,it,bounds", [(2, 1, (0.0, math.inf)), (3, 40, (0.0, math.inf)),
                                         (2, 5, (0.9, 1.1))])
def test_adapt_pooled_matches_jax(d, it, bounds):
    rng = np.random.default_rng(10 + d)
    C = 64
    S = np.broadcast_to(np.linalg.cholesky(_spd(rng, d)), (C, d, d)).astype(np.float32)
    U = rng.normal(size=(C, d)).astype(np.float32)
    la = np.minimum(rng.normal(-1.0, 1.0, size=C), 0.0).astype(np.float32)
    port_state, ref_state = _states(np.zeros((C, d), np.float32), np.zeros(C, np.float32),
                                    S, np.full(C, it))
    kw = dict(pooled=True, eigenvalue_lower_bound=bounds[0], eigenvalue_upper_bound=bounds[1])
    S_new, eta = RobustAdaptiveMetropolis(**kw)._adapt_pooled(port_state, _t(la), _t(U))
    want_S, want_eta = ref.RobustAdaptiveMetropolis(**kw)._adapt_pooled(
        ref_state, jnp.asarray(la), jnp.asarray(U))
    np.testing.assert_allclose(float(eta), float(want_eta), rtol=1e-6)
    np.testing.assert_allclose(S_new.numpy(), np.asarray(want_S), rtol=1e-5, atol=1e-5)


# ---- the torch engine (tests/test_ram.py's tolerances) -------------------------


def _corr_model(cov=SIG):
    return correlated_gaussian_from_numpy(cov, device="cpu")


def test_covariance_recovery():
    res = sample(_corr_model(), RobustAdaptiveMetropolis(), 1000, key=0, num_chains=64,
                 num_warmup=1000, initial_params=[0.0, 0.0])
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(draws.T), SIG, rtol=0.2, atol=0.1)


@pytest.mark.parametrize("sigma2,hits", [(10.0, "upper"), (0.01, "lower")])
def test_eigenvalue_bounds(sigma2, hits):
    cov = np.array([[sigma2, sigma2 / 2], [sigma2 / 2, sigma2]])
    spl = RobustAdaptiveMetropolis(gamma=0.51, eigenvalue_lower_bound=0.9,
                                   eigenvalue_upper_bound=1.1)
    res = sample(_corr_model(cov), spl, 1000, key=2, num_warmup=1000, discard_initial=0,
                 initial_params=[0.0, 0.0], collect_states=True)
    eigs = torch.diagonal(res.states.S, dim1=-2, dim2=-1).numpy()
    assert (eigs >= 0.9 - 1e-5).all() and (eigs <= 1.1 + 1e-5).all()
    edge = eigs.max(0) if hits == "upper" else eigs.min(0)
    np.testing.assert_allclose(edge, 1.1 if hits == "upper" else 0.9, atol=0.05)


def test_S_frozen_after_warmup_and_logalpha_bounded():
    res = sample(_corr_model(np.eye(2)), RobustAdaptiveMetropolis(), 50, key=4,
                 num_warmup=100, discard_initial=100, collect_states=True,
                 initial_params=[0.0, 0.0])
    S = res.states.S
    assert torch.equal(S, S[:1].expand_as(S))
    assert (res.states.logalpha <= 0.0).all()


def test_wrong_size_S_raises():
    with pytest.raises(ValueError, match="wrong dimensionality"):
        sample(_corr_model(np.eye(2)), RobustAdaptiveMetropolis(S=np.eye(3)), 10, key=3,
               initial_params=[0.0, 0.0])


def test_pooled_acceptance_near_target():
    C = np.array([[2.0, 0.8], [0.8, 1.0]])
    res = sample(_corr_model(C), RobustAdaptiveMetropolis(pooled=True), 1000, key=1,
                 num_chains=64, num_warmup=1000, discard_initial=1000,
                 initial_params=[0.0, 0.0])
    assert abs(float(res.transitions.accepted.float().mean()) - 0.234) < 0.08
    x = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(x.T), C, rtol=0.2)
    S = res.final_state.S
    assert torch.equal(S, S[:1].expand_as(S))


# ---- the fused kernel's plain version -------------------------------------------


def test_fused_plain_recovers_covariance_and_acceptance():
    """``sample(engine="fused")`` on CPU tensors runs the kernel's plain
    version: the tolerances of tests/test_pallas.py::test_sample_engine_fused_ram."""
    res = sample(_corr_model(), RobustAdaptiveMetropolis(), 1000, key=5, num_chains=256,
                 engine="fused", num_warmup=1500, initial_params=[0.0, 0.0])
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(draws.T), SIG, rtol=0.1, atol=0.05)
    assert abs(float(res.transitions.accepted.float().mean()) - 0.234) < 0.05
    S = res.final_state.S.numpy()
    SS = np.einsum("cij,ckj->cik", S, S).mean(0)
    assert abs(SS[0, 1] / np.sqrt(SS[0, 0] * SS[1, 1]) - 0.5) < 0.1


@pytest.mark.parametrize("pooled", [False, True])
def test_fused_split_run_is_bit_identical(pooled):
    """A fused run resumed from its final state (num_warmup=0,
    discard_initial=thinning) with iteration_offset continues the stream."""
    m, spl = _corr_model(), RobustAdaptiveMetropolis(pooled=pooled)
    kw = dict(key=9, num_chains=6, engine="fused", initial_params=[0.0, 0.0])
    whole = sample(m, spl, 20, num_warmup=15, **kw)
    first = sample(m, spl, 10, num_warmup=15, **kw)
    second = sample(m, spl, 10, num_warmup=0, discard_initial=1, initial_state=first.final_state,
                    iteration_offset=15 + 10, **kw)
    joined = torch.cat([first.transitions.params, second.transitions.params], dim=1)
    assert torch.equal(joined, whole.transitions.params)
    assert int(second.final_state.iteration[0]) == 15 + 20 + 1


def test_fused_pooled_resume_guard():
    m = _corr_model()
    per_chain = sample(m, RobustAdaptiveMetropolis(), 5, key=1, num_chains=8, engine="fused",
                       num_warmup=50, initial_params=[0.0, 0.0])
    with pytest.raises(ValueError, match="per-chain factors"):
        sample(m, RobustAdaptiveMetropolis(pooled=True), 5, key=1, num_chains=8,
               engine="fused", num_warmup=0, discard_initial=1,
               initial_state=per_chain.final_state, iteration_offset=55)


def test_fused_schedule_checks():
    m = _corr_model()
    with pytest.raises(ValueError, match="discard_initial == num_warmup"):
        sample(m, RobustAdaptiveMetropolis(), 5, num_chains=4, engine="fused",
               num_warmup=10, discard_initial=3, initial_params=[0.0, 0.0])


def test_nan_start_rejects_and_keeps_S():
    """Both lps −inf make logα NaN: the step rejects, and the sweep's
    r2 > 0 is false, so S is kept (jnp.minimum and jnp.sign propagate NaN;
    fminf would not)."""
    model = gaussian_mean_scale_from_numpy(np.random.default_rng(1234).normal(size=30),
                                           device="cpu")
    C = 32
    x = torch.stack([torch.zeros(C), torch.full((C,), -5.0)])  # σ < 0
    lp = model.tile_density(x, *model.tile_consts)
    S = (0.1 * torch.eye(2)).reshape(4, 1).expand(4, C).contiguous()
    U, logu = step_noise(3, 1, 1, C, 2, "cpu")
    x2, lp2, S2, acc = ram_step(x, lp, S, U[0], logu[0], RamParams(), 1,
                                model.tile_density, model.tile_consts)
    assert torch.isneginf(lp).all() and not acc.any()
    assert torch.equal(S2, S) and torch.equal(x2, x)
    out = fused_ram_sample(model.tile_density, model.cuda_density, x, lp, S,
                           model.tile_consts, 3, warmup=5, thin=1, n_samples=2)
    assert torch.equal(out[3], S) and not out[2].any()
