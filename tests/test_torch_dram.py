"""DRAM and the Haario banana in advancedmh_tpu_torch against advancedmh_tpu.

- ``banana_model``: the density (per point and batched), the gradient, the
  tile density and the tile value-and-grad against the JAX model at random
  points (f32 tolerance);
- ``dram_move`` fed the draws JAX's key splits give, against JAX's
  ``step_batched`` (1e-5, decisions equal);
- tests/test_dram.py's assertions on the torch engine, at their tolerances
  (fewer steps);
- the fused engine on its plain version: moments within Monte-Carlo error
  of the torch engine, a split run bit for bit with the final count, and the
  errors for pooled, d > 8 and a bad γ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models.targets import banana_model as jax_banana
from advancedmh_tpu.models.targets import correlated_gaussian_model as jax_corr
from advancedmh_tpu.samplers.am import AdaptiveMetropolisState as JState
from advancedmh_tpu_torch import DRAM, DensityModel, ess_bulk, sample
from advancedmh_tpu_torch.convert import am_state_from_numpy, correlated_gaussian_from_numpy
from advancedmh_tpu_torch.models import (banana_model, correlated_gaussian_model,
                                         gaussian_mean_scale_model)

COV = np.array([[4.0, 1.8], [1.8, 1.0]], np.float32)
PREC = torch.as_tensor(np.linalg.inv(COV).astype(np.float32))
CORR_MODEL = DensityModel(lambda th: -0.5 * torch.einsum("...i,ij,...j->...", th, PREC, th),
                          dimension=2, device="cpu")
SIG = np.array([[1.5, 0.35], [0.35, 1.0]], np.float32)


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


def _close(a, b, tol, atol=None):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol if atol is None else atol)


# ---- the banana ------------------------------------------------------------------------


def test_banana_matches_jax():
    """Value, gradient and the tile forms at points across the ridge: the
    same float32 operations in the JAX model's order, so 1e-6 relative."""
    pts = (np.random.default_rng(0).normal(size=(256, 2)) * [10.0, 3.0]).astype(np.float32)
    jm, pm = jax_banana(), banana_model(device="cpu")
    lp, g = jax.vmap(jm.logdensity_and_gradient_fn)(jnp.asarray(pts))
    _close(jax.vmap(jm.logdensity_fn)(jnp.asarray(pts)), lp, 1e-6)
    x = _t(pts)
    _close(pm.logdensity_fn(x), lp, 1e-6, 1e-6)
    _close(pm.logdensity_batched_fn(x), lp, 1e-6, 1e-6)
    lp_p, g_p = pm.logdensity_and_gradient_fn(x.T)
    _close(lp_p, lp, 1e-6, 1e-6)
    _close(g_p.T, g, 1e-6, 1e-6)
    _close(pm.tile_density(x.T.contiguous(), *pm.tile_consts)[0],
           jm.tile_density(jnp.asarray(pts.T))[0], 1e-6, 1e-6)
    tlp, tg = pm.tile_value_and_grad(x.T.contiguous(), *pm.tile_consts)
    _close(tlp[0], lp, 1e-6, 1e-6)
    _close(tg.T, g, 1e-6, 1e-6)
    lp1 = pm.logdensity_fn(x[0])
    lp1_grad = pm.logdensity_and_gradient_fn(x[0])[1]
    _close(lp1, lp[0], 1e-6, 1e-6)
    _close(lp1_grad, g[0], 1e-6, 1e-6)


# ---- one step on JAX's draws ------------------------------------------------------


@pytest.mark.parametrize("target", ["corr", "banana"])
def test_dram_move_matches_jax_on_its_draws(target):
    C, d = 64, 2
    rng = np.random.default_rng(4)
    if target == "corr":
        jm, pm = jax_corr(SIG), correlated_gaussian_from_numpy(SIG, device="cpu")
        x = rng.normal(size=(C, d)).astype(np.float32)
    else:
        jm, pm = jax_banana(), banana_model(device="cpu")
        x = (rng.normal(size=(C, d)) * [10.0, 2.0]).astype(np.float32)
    L = np.tril(rng.normal(0.0, 0.3, (C, d, d)), -1)
    L[:, np.arange(d), np.arange(d)] = rng.uniform(0.5, 1.5, (C, d))
    s = dict(x=x, logprob=np.asarray(jax.vmap(jm.logdensity_fn)(jnp.asarray(x))),
             mean=rng.normal(0.0, 0.5, (C, d)).astype(np.float32), L=L.astype(np.float32),
             iteration=rng.integers(1, 3000, C).astype(np.int32), isaccept=np.ones(C, bool))
    jst = JState(**{k: jnp.asarray(v) for k, v in s.items()})
    pst = am_state_from_numpy(**s, device="cpu")
    jstep = jax.jit(lambda k, st: ref.DRAM().step_batched(k, st, jm, (C,))[1])
    for i in range(5):
        key = jax.random.fold_in(jax.random.key(4), i)
        key_z1, key_a1, key_z2, key_a2 = jax.random.split(key, 4)
        z1, z2 = (jax.random.normal(k, (C, d)) for k in (key_z1, key_z2))
        e1, e2 = (jax.random.exponential(k, (C,)) for k in (key_a1, key_a2))
        jst = jstep(key, jst)
        pst = DRAM().dram_move(pm, pst, _t(z1), _t(z2), _t(e1), _t(e2), (C,))
        np.testing.assert_array_equal(pst.isaccept.numpy(), np.asarray(jst.isaccept))
        np.testing.assert_array_equal(pst.iteration.numpy(), np.asarray(jst.iteration))
        for f in ("x", "logprob", "mean", "L"):
            _close(getattr(pst, f), getattr(jst, f), 1e-5)


# ---- tests/test_dram.py on the torch engine -------------------------------------------


class TestDRAMTorchEngine:
    def test_correlated_covariance_recovery(self):
        res = sample(CORR_MODEL, DRAM(), 1000, key=0, num_chains=64,
                     initial_params=torch.zeros(2), discard_initial=500)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.25 * float(COV.max()))

    def test_readme_model_moments(self):
        model = gaussian_mean_scale_model(n_obs=300, device="cpu")
        res = sample(model, DRAM(), 1000, key=1, num_chains=64,
                     initial_params=torch.tensor([0.0, 1.0]), discard_initial=500)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert abs(draws[:, 0].mean()) < 0.1
        assert abs(draws[:, 1].mean() - 1.0) < 0.1

    def test_single_chain_step_path(self):
        res = sample(CORR_MODEL, DRAM(), 2500, key=2, initial_params=torch.zeros(2),
                     discard_initial=500)
        draws = res.transitions.params.numpy()
        np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.3 * float(COV.max()))

    def test_adapted_l_tracks_target(self):
        res = sample(CORR_MODEL, DRAM(), 1500, key=3, num_chains=64,
                     initial_params=torch.zeros(2), discard_initial=0)
        L = res.final_state.L.numpy()
        sigma = np.einsum("cij,ckj->cik", L, L).mean(axis=0)
        corr = sigma[0, 1] / np.sqrt(sigma[0, 0] * sigma[1, 1])
        assert abs(corr - COV[0, 1] / np.sqrt(COV[0, 0] * COV[1, 1])) < 0.12
        assert abs(sigma[0, 0] / sigma[1, 1] - COV[0, 0] / COV[1, 1]) < 1.2

    def test_stage2_keeps_chain_moving_early(self):
        res = sample(CORR_MODEL, DRAM(fixed_scale=30.0, gamma=0.02), 200, key=4, num_chains=256,
                     initial_params=torch.zeros(2), discard_initial=0)
        assert float(res.transitions.accepted[:50].float().mean()) > 0.15

    def test_bad_gamma_raises(self):
        with pytest.raises(ValueError, match="gamma"):
            DRAM(gamma=1.5)

    def test_resume_state_roundtrip(self):
        kw = dict(key=5, num_chains=8)
        full = sample(CORR_MODEL, DRAM(), 150, initial_params=torch.zeros(2), **kw)
        part1 = sample(CORR_MODEL, DRAM(), 100, initial_params=torch.zeros(2), **kw)
        part2 = sample(CORR_MODEL, DRAM(), 50, initial_state=part1.final_state,
                       iteration_offset=part1.schedule.total_steps, discard_initial=1, **kw)
        assert torch.equal(full.transitions.lp,
                           torch.cat([part1.transitions.lp, part2.transitions.lp], 1))


# ---- the fused engine on its plain version --------------------------------------------


def test_fused_dram_moments_match_torch_engine():
    model = correlated_gaussian_model(SIG, device="cpu")
    kw = dict(num_chains=256, initial_params=torch.zeros(2), discard_initial=600)
    fused = sample(model, DRAM(), 600, key=11, engine="fused", **kw)
    torch_ = sample(model, DRAM(), 600, key=12, **kw)
    a, b = fused.transitions.params, torch_.transitions.params
    for j in range(2):
        se = [float(torch.var(x[..., j])) / float(ess_bulk(x[..., j].T)) for x in (a, b)]
        assert abs(float(a[..., j].mean() - b[..., j].mean())) < 4.0 * (se[0] + se[1]) ** 0.5
    np.testing.assert_allclose(np.cov(a.reshape(-1, 2).numpy().T), SIG, rtol=0.1, atol=0.05)
    assert 0.2 < float(fused.transitions.accepted.float().mean()) < 0.9


def test_fused_dram_split_run_is_bit_exact_and_counts():
    model = banana_model(device="cpu")
    kw = dict(key=3, num_chains=100, engine="fused", thinning=3, initial_params=torch.zeros(2))
    whole = sample(model, DRAM(), 20, discard_initial=6, **kw)
    first = sample(model, DRAM(), 8, discard_initial=6, **kw)
    rest = sample(model, DRAM(), 12, discard_initial=3, initial_state=first.final_state,
                  iteration_offset=3 + 24, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))
    for f in ("mean", "L", "iteration"):
        assert torch.equal(getattr(rest.final_state, f), getattr(whole.final_state, f))
    assert bool((whole.final_state.iteration == 1 + 3 + 20 * 3).all())


def test_fused_dram_errors():
    model = correlated_gaussian_model(SIG, device="cpu")
    kw = dict(key=0, num_chains=8, engine="fused")
    with pytest.raises(ValueError, match="pooled"):
        sample(model, DRAM(pooled=True), 10, initial_params=torch.zeros(2), **kw)
    with pytest.raises(ValueError, match="d <= 8"):
        sample(correlated_gaussian_model(np.eye(9), device="cpu"), DRAM(), 10,
               initial_params=torch.zeros(9), **kw)
    for g in (0.0, 1.0):
        with pytest.raises(ValueError, match="gamma"):
            DRAM(gamma=g)
