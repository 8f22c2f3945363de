"""Adaptive Metropolis in advancedmh_tpu_torch against advancedmh_tpu.

- the Welford moments: the per-chain update and the pooled merge against
  JAX's ``_moments_update`` / ``_moments_update_pooled`` on one state, and
  the kernels' form (``ops/am.py::welford_advance``) against the Pallas
  kernel's ``_welford_advance`` (f32 tolerance);
- ``am_move`` fed the draws JAX's key splits give, against JAX's
  ``step_batched`` (1e-5, decisions equal);
- tests/test_am.py's assertions on the torch engine, at their tolerances;
- the fused engine on its plain version: moments within Monte-Carlo error
  of the torch engine, a split run bit for bit, the final count, the plain
  step against the torch-engine step on the same noise, and the errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models.targets import correlated_gaussian_model as jax_corr
from advancedmh_tpu.models.targets import gaussian_mean_scale_model as jax_flagship
from advancedmh_tpu.ops.pallas_am import _welford_advance as pallas_welford
from advancedmh_tpu.samplers.am import AdaptiveMetropolisState as JState
from advancedmh_tpu_torch import (DRAM, AdaptiveMetropolis, DensityModel, Normal, ess_bulk,
                                  guarded_logdensity, sample)
from advancedmh_tpu_torch.convert import am_state_from_numpy, correlated_gaussian_from_numpy
from advancedmh_tpu_torch.models import correlated_gaussian_model, gaussian_mean_scale_model
from advancedmh_tpu_torch.ops import AmParams, am_step, welford_advance
from advancedmh_tpu_torch.ops.am import lower
from advancedmh_tpu_torch.ops.rwmh import philox_uniforms, box_muller

COV = np.array([[1.5, 0.35], [0.35, 1.0]], np.float32)
MODEL = correlated_gaussian_model(COV, device="cpu")


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


def _random_state(C, d, seed):
    """A state with spread moments: x, lp, mean, a lower factor with a
    positive diagonal, and counts 1..5000."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.normal(0.0, 0.3, (C, d, d)), -1)
    L[:, np.arange(d), np.arange(d)] = rng.uniform(0.5, 1.5, (C, d))
    return dict(x=rng.normal(size=(C, d)).astype(np.float32),
                logprob=rng.normal(size=C).astype(np.float32),
                mean=rng.normal(0.0, 0.5, (C, d)).astype(np.float32),
                L=L.astype(np.float32), iteration=rng.integers(1, 5000, C).astype(np.int32),
                isaccept=np.ones(C, bool))


def _jstate(s):
    return JState(**{k: jnp.asarray(v) for k, v in s.items()})


# ---- the moments --------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 5])
def test_moments_update_matches_jax(d):
    s = _random_state(64, d, d)
    x_new = np.random.default_rng(10 + d).normal(size=(64, d)).astype(np.float32)
    got = AdaptiveMetropolis()._moments_update(am_state_from_numpy(**s, device="cpu"), _t(x_new))
    want = ref.AdaptiveMetropolis()._moments_update(_jstate(s), jnp.asarray(x_new))
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("d", [2, 5])
def test_pooled_merge_matches_jax(d):
    """One shared (mean, L) from chain 0's moments and all C new states; the
    port sums the outer products elementwise, JAX at Precision.HIGHEST, then
    both refactorize: 1e-4 for the sum's order through the Cholesky."""
    s = _random_state(64, d, 20 + d)
    s["iteration"][:] = 300
    x_new = np.random.default_rng(30 + d).normal(size=(64, d)).astype(np.float32)
    pst = am_state_from_numpy(**s, device="cpu")
    mean, L, it = AdaptiveMetropolis(pooled=True)._advance_moments(pst, _t(x_new), True)
    jm, jL, jit = ref.AdaptiveMetropolis(pooled=True)._advance_moments(
        _jstate(s), jnp.asarray(x_new), True)
    _close(mean, jm, 1e-5)
    _close(L, jL, 1e-4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    assert torch.equal(L, L[0].expand_as(L))


def test_kernel_welford_matches_pallas_helper():
    """ops/am.py::welford_advance (the kernels' order: inv = 1/(n+1),
    sqrt(n·inv), sqrt(n)·inv) against pallas_am.py's _welford_advance, run
    as plain jnp on the kernel's (d, C) rows."""
    d, C = 4, 128
    s = _random_state(C, d, 3)
    x, mean = s["x"].T.copy(), s["mean"].T.copy()
    L = s["L"].reshape(C, d * d).T.copy()
    n = s["iteration"].astype(np.float32)[None]
    got = welford_advance(_t(x), _t(mean), _t(L), _t(n))
    jm, jL, jn = pallas_welford([jnp.asarray(x[r:r + 1]) for r in range(d)],
                                [jnp.asarray(mean[r:r + 1]) for r in range(d)],
                                [jnp.asarray(L[r:r + 1]) for r in range(d * d)],
                                jnp.asarray(n), d)
    _close(got[0], np.concatenate(jm), 1e-6)
    _close(lower(got[1], d), np.concatenate(jL), 1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jn))


# ---- one step on JAX's draws ------------------------------------------------------


@pytest.mark.parametrize("target", ["corr", "flagship"])
def test_am_move_matches_jax_on_its_draws(target):
    C = 64
    rng = np.random.default_rng(1)
    if target == "corr":
        jm, pm = jax_corr(COV), correlated_gaussian_from_numpy(COV, device="cpu")
        x = rng.normal(size=(C, 2)).astype(np.float32)
    else:
        jm, pm = jax_flagship(), gaussian_mean_scale_model(device="cpu")
        x = np.stack([rng.normal(0.0, 0.3, C), rng.uniform(0.6, 2.0, C)], 1).astype(np.float32)
    kw = dict(adapt_start=3, beta=0.3)
    lp = np.asarray(jax.vmap(jm.logdensity_fn)(jnp.asarray(x)))
    s = dict(x=x, logprob=lp, mean=x, L=np.tile(0.1 / np.sqrt(2) * np.eye(2, dtype=np.float32),
                                                (C, 1, 1)),
             iteration=np.ones(C, np.int32), isaccept=np.ones(C, bool))
    jst, pst = _jstate(s), am_state_from_numpy(**s, device="cpu")
    jstep = jax.jit(lambda k, st: ref.AdaptiveMetropolis(**kw).step_batched(k, st, jm, (C,))[1])
    for i in range(5):
        key = jax.random.fold_in(jax.random.key(2), i)
        key_inc, key_acc = jax.random.split(key)
        key_z, key_b = jax.random.split(key_inc)
        z = jax.random.normal(key_z, (C, 2))
        u = jax.random.uniform(key_b, (C,))
        e = jax.random.exponential(key_acc, (C,))
        jst = jstep(key, jst)
        pst = AdaptiveMetropolis(**kw).am_move(pm, pst, _t(z), _t(u), _t(e), (C,))
        np.testing.assert_array_equal(pst.isaccept.numpy(), np.asarray(jst.isaccept))
        np.testing.assert_array_equal(pst.iteration.numpy(), np.asarray(jst.iteration))
        for f in ("x", "logprob", "mean", "L"):
            _close(getattr(pst, f), getattr(jst, f), 1e-5)


# ---- tests/test_am.py on the torch engine ---------------------------------------------


class TestAMTorchEngine:
    def test_samples_recover_covariance_and_accept(self):
        res = sample(MODEL, AdaptiveMetropolis(), 1500, key=0, num_chains=64,
                     initial_params=torch.zeros(2), num_warmup=1000, discard_initial=1000)
        x = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(x.mean(0), np.zeros(2), atol=0.1)
        np.testing.assert_allclose(np.cov(x.T), COV, rtol=0.2)
        assert 0.2 < float(res.transitions.accepted.float().mean()) < 0.6

    def test_adapted_factor_learns_covariance_and_tracks_history(self):
        res = sample(MODEL, AdaptiveMetropolis(), 3000, key=1, num_chains=16,
                     initial_params=torch.zeros(2), discard_initial=0)
        L = res.final_state.L.numpy()
        np.testing.assert_allclose(np.einsum("cij,ckj->cik", L, L).mean(0), COV, rtol=0.3)
        np.testing.assert_allclose(res.final_state.mean.numpy().mean(0), np.zeros(2), atol=0.2)
        it = res.final_state.iteration.numpy()
        assert (it == it[0]).all() and it[0] == 1 + res.schedule.total_steps

    def test_fixed_phase_only(self):
        res = sample(MODEL, AdaptiveMetropolis(adapt_start=10**9, fixed_scale=2.0), 1500, key=3,
                     num_chains=64, initial_params=torch.zeros(2), discard_initial=300)
        x = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(x.mean(0), np.zeros(2), atol=0.15)

    def test_single_chain_unbatched_path(self):
        res = sample(MODEL, AdaptiveMetropolis(), 200, key=5, initial_params=torch.zeros(2))
        assert tuple(res.transitions.lp.shape) == (200,)
        assert bool(torch.isfinite(res.transitions.lp).all())

    def test_resume_bit_exact(self):
        spl = AdaptiveMetropolis()
        kw = dict(key=6, num_chains=4, discard_initial=1)
        full = sample(MODEL, spl, 200, initial_params=torch.zeros(2), **kw)
        p1 = sample(MODEL, spl, 100, initial_params=torch.zeros(2), **kw)
        p2 = sample(MODEL, spl, 100, initial_state=p1.final_state,
                    iteration_offset=p1.schedule.total_steps, **kw)
        assert torch.equal(full.transitions.params[:, 100:], p2.transitions.params)

    def test_needs_dimension(self):
        with pytest.raises(ValueError, match="dimension"):
            sample(DensityModel(lambda t: -torch.sum(t ** 2), device="cpu"),
                   AdaptiveMetropolis(), 10, key=7)

    def test_support_guarded_model(self):
        data = torch.as_tensor(np.random.default_rng(1234).normal(size=300), dtype=torch.float32)
        ld = guarded_logdensity(
            support_fn=lambda t: t[..., 1] >= 0,
            logdensity_fn=lambda t: torch.sum(Normal(t[..., 0:1], t[..., 1:2]).log_prob(data), -1),
            safe_params_fn=lambda t: torch.stack([t[..., 0], torch.clamp(t[..., 1], min=0.1)],
                                                 -1))
        model = DensityModel(ld, dimension=2, device="cpu")
        res = sample(model, AdaptiveMetropolis(), 1000, key=8, num_chains=32,
                     initial_params=torch.tensor([0.0, 1.0]), discard_initial=500)
        x = res.transitions.params.reshape(-1, 2).numpy()
        assert abs(x[:, 0].mean()) < 0.1 and abs(x[:, 1].mean() - 1.0) < 0.1


class TestPooledTorchEngine:
    @staticmethod
    def _corr6():
        C = 0.5 * np.ones((6, 6), np.float32) + 0.5 * np.eye(6, dtype=np.float32)
        return correlated_gaussian_model(C, device="cpu"), C

    def test_pooled_beats_per_chain_at_equal_budget(self):
        model, sig = self._corr6()
        kw = dict(key=0, num_chains=128, initial_params=torch.zeros(6))
        pooled = sample(model, AdaptiveMetropolis(pooled=True), 150, **kw)
        per = sample(model, AdaptiveMetropolis(), 150, **kw)

        def cov_err(L):
            C = L @ np.swapaxes(L, -1, -2)
            C = C / np.trace(C, axis1=-2, axis2=-1)[..., None, None]
            return np.abs(C - sig / np.trace(sig)).max(axis=(-2, -1))

        assert cov_err(pooled.final_state.L.numpy()[0]) < cov_err(per.final_state.L.numpy()).mean()

    def test_pooled_moments_replicated_and_counted(self):
        model, _ = self._corr6()
        res = sample(model, AdaptiveMetropolis(pooled=True), 50, key=1, num_chains=16,
                     initial_params=torch.zeros(6))
        L = res.final_state.L
        assert torch.equal(L, L[0].expand_as(L))
        assert int(res.final_state.iteration[0]) == 1 + 16 * 49

    @pytest.mark.parametrize("spl", [AdaptiveMetropolis(pooled=True), DRAM(pooled=True)],
                             ids=["am", "dram"])
    def test_pooled_posterior_moments(self, spl):
        res = sample(MODEL, spl, 1500, key=2, num_chains=64, initial_params=torch.zeros(2),
                     num_warmup=500, discard_initial=500)
        x = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(x.mean(0), np.zeros(2), atol=0.1)
        np.testing.assert_allclose(np.cov(x.T), COV, rtol=0.2)
        L = res.final_state.L
        assert torch.equal(L, L[0].expand_as(L))


# ---- the fused engine on its plain version --------------------------------------------


def _moments_agree(a, b):
    """Per coordinate, |mean_a − mean_b| within 4 combined MCSE (each from
    its own bulk ESS)."""
    for j in range(a.shape[-1]):
        se = [float(torch.var(x[..., j])) / float(ess_bulk(x[..., j].T)) for x in (a, b)]
        assert abs(float(a[..., j].mean() - b[..., j].mean())) < 4.0 * (se[0] + se[1]) ** 0.5


def test_fused_am_moments_match_torch_engine():
    kw = dict(num_chains=256, initial_params=torch.zeros(2), discard_initial=800)
    fused = sample(MODEL, AdaptiveMetropolis(), 800, key=11, engine="fused", **kw)
    torch_ = sample(MODEL, AdaptiveMetropolis(), 800, key=12, **kw)
    _moments_agree(fused.transitions.params, torch_.transitions.params)
    x = fused.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(x.T), COV, rtol=0.1, atol=0.05)
    assert bool((fused.final_state.iteration == 1 + 799 + 800).all())


def test_fused_am_split_run_is_bit_exact_and_counts():
    kw = dict(key=3, num_chains=100, engine="fused", thinning=3, initial_params=torch.zeros(2))
    whole = sample(MODEL, AdaptiveMetropolis(), 20, discard_initial=6, **kw)
    first = sample(MODEL, AdaptiveMetropolis(), 8, discard_initial=6, **kw)
    rest = sample(MODEL, AdaptiveMetropolis(), 12, discard_initial=3,
                  initial_state=first.final_state, iteration_offset=3 + 24, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))
    for f in ("mean", "L", "iteration", "x", "logprob"):
        assert torch.equal(getattr(rest.final_state, f), getattr(whole.final_state, f))
    assert bool((whole.final_state.iteration == 1 + 3 + 20 * 3).all())


def test_plain_step_follows_torch_engine_step_on_the_same_noise():
    """The plain kernel step (ops/am.py::am_step, the kernel's order) and the
    torch engine's am_move (XLA's order) on the same noise over 100 steps:
    the same decisions, and (mean, L) within f32 rounding."""
    C, d = 256, 2
    x = torch.zeros(d, C)
    lp = MODEL.tile_density(x, *MODEL.tile_consts)
    mean, n = x.clone(), torch.ones(1, C)
    L = (0.1 / np.sqrt(d) * torch.eye(d)).reshape(d * d, 1).expand(d * d, C).contiguous()
    st = am_state_from_numpy(x.T.numpy(), lp[0].numpy(), x.T.numpy(),
                             np.tile(0.1 / np.sqrt(d) * np.eye(d), (C, 1, 1)),
                             np.ones(C), np.ones(C, bool), device="cpu")
    spl, k = AdaptiveMetropolis(), AmParams().constants(d)
    u = philox_uniforms(77, 1, 100, C, 4, "cpu")
    z = box_muller(u, d)
    for t in range(100):
        x, lp, mean, L, n, acc = am_step(x, lp, mean, L, n, z[t], u[None, t, :, 2],
                                         torch.log(u[None, t, :, 3]), k, MODEL.tile_density,
                                         MODEL.tile_consts)
        st = spl.am_move(MODEL, st, z[t].T, u[t, :, 2], -torch.log(u[t, :, 3]), (C,))
        assert torch.equal(acc[0], st.isaccept)
    _close(mean.T, st.mean, 1e-5)
    _close(L.T.reshape(C, d, d), st.L, 1e-5)
    assert torch.equal(n[0].to(torch.int32), st.iteration)


def test_fused_am_errors():
    with pytest.raises(ValueError, match="pooled"):
        sample(MODEL, AdaptiveMetropolis(pooled=True), 10, key=0, num_chains=8, engine="fused",
               initial_params=torch.zeros(2))
    with pytest.raises(ValueError, match="initial_params"):
        sample(MODEL, AdaptiveMetropolis(), 10, key=0, num_chains=8, engine="fused")
    big = correlated_gaussian_model(np.eye(9), device="cpu")
    with pytest.raises(ValueError, match="d <= 8"):
        sample(big, AdaptiveMetropolis(), 10, key=0, num_chains=8, engine="fused",
               initial_params=torch.zeros(9))
