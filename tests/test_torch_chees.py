"""ChEES-HMC in advancedmh_tpu_torch against advancedmh_tpu.

- ``vdc`` / ``halton_trips`` equal to ops/pallas_chees.py's;
- the adaptation pieces (``_dual_avg_eps``, ``_adam_update``,
  ``_chees_grad`` with unhealthy and NaN chains, ``_welford_pooled``,
  ``_regularized_inverse_mass``) and the warmup's tile combine against the
  JAX functions on the same inputs (1e-6);
- one ``step_warmup_batched`` and one ``step_batched`` driven by JAX's own
  random numbers (1e-5);
- tests/test_chees.py's assertions on the torch engine, at their tolerances;
- the fused engine on the kernels' plain versions (tests/test_pallas.py's
  ChEES checks at ~1024 chains), its split run bit for bit, its errors and
  the state carried across from the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.ops import pallas_chees
from advancedmh_tpu.runtime import fused as ref_fused
from advancedmh_tpu.samplers.chees import ChEESHMCState as RefState
from advancedmh_tpu_torch import ChEESHMC, DensityModel, sample
from advancedmh_tpu_torch.convert import (chees_state_from_numpy,
                                          correlated_gaussian_from_numpy,
                                          gradient_transition_from_numpy)
from advancedmh_tpu_torch.ops import halton_trips, vdc
from advancedmh_tpu_torch.runtime.fused import (chees_frozen_stage, chees_warmup_combine,
                                                fused_tile, sample_fused_chees)

COV = np.asarray([[1.5, 0.35], [0.35, 1.0]], np.float32)
FIELDS = ("log_eps", "log_eps_bar", "h_bar", "log_traj", "log_traj_bar", "adam_m", "adam_v",
          "t", "mean", "m2", "n", "inverse_mass")


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


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


def test_vdc_and_halton_trips_equal_the_jax_schedule():
    assert [vdc(i) for i in range(1, 200)] == [pallas_chees.vdc(i) for i in range(1, 200)]
    for ratio, n, max_l in ((1, 16, 8), (7, 32, 16), (13, 16, 8), (300, 48, 256), (3, 5, 2)):
        assert halton_trips(ratio, n, max_l) == pallas_chees.halton_trips(ratio, n, max_l)


def _states(rng, C=32, d=3):
    """The same replicated ChEES statistics for both packages."""
    scal = dict(log_eps=np.log(0.3), log_eps_bar=np.log(0.25), h_bar=0.04, log_traj=0.2,
                log_traj_bar=0.1, adam_m=0.3, adam_v=0.05, n=150.0)
    f = {k: np.full(C, v, np.float32) for k, v in scal.items()}
    f["t"] = np.full(C, 7, np.int32)
    f["mean"] = np.broadcast_to(rng.normal(size=d), (C, d)).astype(np.float32)
    f["m2"] = np.broadcast_to(rng.uniform(5.0, 30.0, size=d), (C, d)).astype(np.float32)
    f["inverse_mass"] = np.broadcast_to(rng.uniform(0.5, 2.0, size=d), (C, d)).astype(np.float32)
    x = rng.normal(size=(C, d)).astype(np.float32)
    lp = rng.normal(size=C).astype(np.float32)
    inner_j = ref.samplers.base.GradientTransition(jnp.asarray(x), jnp.asarray(lp),
                                                   jnp.asarray(-x), jnp.zeros(C, bool))
    jst = RefState(inner=inner_j, **{k: jnp.asarray(v) for k, v in f.items()})
    inner_p = gradient_transition_from_numpy(x, lp, -x, np.zeros(C, bool), device="cpu")
    pst = chees_state_from_numpy(inner_p, **f, device="cpu")
    return jst, pst


def test_adaptation_pieces_match_jax():
    rng = np.random.default_rng(3)
    jst, pst = _states(rng)
    kw = dict(target_accept=0.7, initial_step_size=0.3, mass_warm_start=12,
              mass_regularization=4.0, max_leapfrog=20, learning_rate=0.05)
    jspl, pspl = ref.ChEESHMC(**kw), ChEESHMC(**kw)
    for a, b in zip(pspl._dual_avg_eps(pst, _t(0.55)), jspl._dual_avg_eps(jst, jnp.float32(0.55))):
        _close(a, b, 1e-6)
    for g in (0.7, -3.5):
        for a, b in zip(pspl._adam_update(pst, _t(g), _t(0.2)),
                        jspl._adam_update(jst, jnp.float32(g), jnp.float32(0.2))):
            _close(a, b, 1e-6)
    # a gradient that drives log T into the clip on both sides
    for g, eps in ((1e6, 0.01), (-1e6, 0.5)):
        a = pspl._adam_update(pst, _t(g), _t(eps))[0]
        b = jspl._adam_update(jst, jnp.float32(g), jnp.float32(eps))[0]
        _close(a, b, 1e-6)
    got = pspl._regularized_inverse_mass(pst.m2, pst.n, pst.inverse_mass)
    want = jspl._regularized_inverse_mass(jst.m2, jst.n, jst.inverse_mass)
    _close(got, want, 1e-6)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    for a, b in zip(pspl._welford_pooled(pst.mean, pst.m2, pst.n, _t(x), (32,)),
                    jspl._welford_pooled(jst.mean, jst.m2, jst.n, jnp.asarray(x), (32,))):
        _close(a, b, 1e-6)


def test_chees_gradient_with_unhealthy_and_nan_chains_matches_jax():
    rng = np.random.default_rng(4)
    jst, pst = _states(rng)
    x1 = rng.normal(size=(32, 3)).astype(np.float32)
    p1 = rng.normal(size=(32, 3)).astype(np.float32)
    x1[3, 1] = 1e12  # astronomical end point
    p1[5, 0] = np.inf  # overflowed momentum
    x1[7, 2] = np.nan  # diverged
    w = rng.uniform(size=32).astype(np.float32)
    w[[3, 5, 7]] = 0.0
    spl_kw = dict(max_leapfrog=20)
    got = ChEESHMC(**spl_kw)._chees_grad(pst, _t(x1), _t(p1), _t(w), _t(0.8), (32,))
    want = ref.ChEESHMC(**spl_kw)._chees_grad(jst, jnp.asarray(x1), jnp.asarray(p1),
                                              jnp.asarray(w), jnp.float32(0.8), (32,))
    assert np.isfinite(float(got))
    _close(got, want, 1e-6)


def test_warmup_combine_matches_jax():
    rng = np.random.default_rng(5)
    d, C, nt = 3, 40, 4
    sv_tiles = rng.normal(size=(9, nt)).astype(np.float32)
    sv_tiles[7] = 201.0
    sx = rng.normal(size=(d, nt)).astype(np.float32) * 50
    sx2 = rng.uniform(500, 900, size=(d, nt)).astype(np.float32)
    x = rng.normal(size=(d, C)).astype(np.float32)
    lp = rng.normal(size=(1, C)).astype(np.float32)
    acc = (rng.uniform(size=(1, C)) < 0.5).astype(np.float32)
    minv0 = np.ones((d, 1), np.float32)
    for adapt in (True, False):
        kw = dict(m_obs=float(C * 200), adapt_mass=adapt, reg=5.0, warm_start=10.0)
        wide = lambda a: jnp.asarray(np.repeat(a, 128, axis=1))
        jst, jsv, jminv = ref_fused._chees_warmup_combine(
            wide(sv_tiles), wide(sx), wide(sx2), jnp.asarray(x), jnp.asarray(lp),
            jnp.asarray(-x), jnp.asarray(acc), jnp.asarray(minv0), num_chains=C, d=d, **kw)
        pst, psv, pminv = chees_warmup_combine(_t(sv_tiles), _t(sx), _t(sx2), _t(x), _t(lp),
                                               _t(-x), _t(acc), _t(minv0), **kw)
        _close(psv, jsv, 1e-6)
        _close(pminv, jminv, 1e-6)
        for name in FIELDS:
            _close(getattr(pst, name), getattr(jst, name), 1e-6)
        assert np.array_equal(pst.inner.accepted.numpy(), np.asarray(jst.inner.accepted))


def _jax_noise(key, shape, C):
    """The draws of JAX's _trajectory_batched for array params."""
    k_mom, k_acc, k_u = jax.random.split(key, 3)
    z = jax.random.normal(jax.random.split(k_mom, 1)[0], shape, jnp.float32)
    e = jax.random.exponential(k_acc, (C,))
    u = jax.random.uniform(k_u, (), jnp.float32)
    return z, e, u


def test_warmup_and_frozen_steps_match_jax_on_its_noise():
    rng = np.random.default_rng(6)
    jst, pst = _states(rng, C=32, d=2)
    jm = ref.models.targets.correlated_gaussian_model(COV)
    pm = _corr()
    spl_kw = dict(max_leapfrog=12, initial_step_size=0.3)
    jspl, pspl = ref.ChEESHMC(**spl_kw), ChEESHMC(**spl_kw)
    for step in ("warmup", "frozen"):
        for i in range(3):
            key = jax.random.fold_in(jax.random.key(11), 10 * (step == "frozen") + i)
            z, e, u = _jax_noise(key, (32, 2), 32)
            if step == "warmup":
                _, jst = jspl.step_warmup_batched(key, jst, jm, (32,))
                _, pst = pspl.step_warmup_from_noise(pst, pm, (32,), _t(z), _t(e), _t(u))
            else:
                _, jst = jspl.step_batched(key, jst, jm, (32,))
                _, pst = pspl.step_from_noise(pst, pm, (32,), _t(z), _t(e), _t(u))
            assert np.array_equal(pst.inner.accepted.numpy(), np.asarray(jst.inner.accepted))
            _close(pst.inner.params, jst.inner.params, 1e-5)
            _close(pst.inner.lp, jst.inner.lp, 1e-5)
            for name in FIELDS:
                _close(getattr(pst, name), getattr(jst, name), 1e-5)


# ---- tests/test_chees.py on the torch engine ---------------------------------------


def _aniso():
    var = torch.tensor([25.0, 0.25])
    return DensityModel(lambda x: -0.5 * torch.sum(x * x / var), device="cpu"), var


class TestChEESTorchEngine:
    def test_bad_hyperparams(self):
        with pytest.raises(ValueError, match="initial_trajectory_length"):
            ChEESHMC(initial_trajectory_length=0.0)
        with pytest.raises(ValueError, match="target_accept"):
            ChEESHMC(target_accept=0.0)
        with pytest.raises(ValueError, match="max_leapfrog"):
            ChEESHMC(max_leapfrog=0)
        with pytest.raises(ValueError, match="learning_rate"):
            ChEESHMC(learning_rate=-1.0)

    def test_requires_initial_params(self):
        model, _ = _aniso()
        with pytest.raises(ValueError, match="initial parameters"):
            sample(model, ChEESHMC(), 10, key=0, num_chains=4)

    def test_trajectory_converges_to_quarter_period(self):
        model, var = _aniso()
        spl = ChEESHMC(initial_trajectory_length=0.5, initial_step_size=0.05, max_leapfrog=64)
        res = sample(model, spl, 400, num_warmup=700, num_chains=256,
                     initial_params=torch.zeros(2), key=5)
        st = res.final_state
        T = float(torch.exp(st.log_traj_bar.reshape(-1)[0]))
        assert 0.9 < T < 2.8, T
        acc = float(res.transitions.accepted.float().mean())
        assert abs(acc - 0.65) < 0.12
        assert np.allclose(st.inverse_mass[0].numpy(), var.numpy(), rtol=0.35)
        x = res.transitions.params.numpy()
        assert np.allclose(x.var(axis=(0, 1)), var.numpy(), rtol=0.3)
        assert np.abs(x.mean(axis=(0, 1)) / np.sqrt(var.numpy())).max() < 0.1

    def test_shared_statistics_replicated_and_frozen(self):
        model, _ = _aniso()
        res = sample(model, ChEESHMC(max_leapfrog=32), 30, num_warmup=60, num_chains=64,
                     initial_params=torch.zeros(2), key=7, collect_states=True)
        st = res.final_state
        for leaf in (st.log_eps, st.log_eps_bar, st.log_traj, st.log_traj_bar, st.adam_m,
                     st.adam_v):
            assert bool((leaf == leaf.reshape(-1)[0]).all())
        im = st.inverse_mass
        assert torch.equal(im, im[:1].expand_as(im))
        lt = res.states.log_traj_bar  # (C, S)
        assert bool((lt[:, 1:] == lt[:, :1]).all())
        assert bool((res.states.inverse_mass[:, 1:] == res.states.inverse_mass[:, :1]).all())

    def test_posterior_covariance_correlated(self):
        res = sample(_corr(), ChEESHMC(initial_step_size=0.05, max_leapfrog=32), 800,
                     num_warmup=500, num_chains=64, initial_params=torch.zeros(2), key=8)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert np.abs(np.cov(draws.T) - COV).max() < 0.2

    def test_no_mass_adaptation_flag(self):
        model, _ = _aniso()
        res = sample(model, ChEESHMC(adapt_mass=False, max_leapfrog=32), 20, num_warmup=50,
                     num_chains=32, initial_params=torch.zeros(2), key=9)
        assert bool((res.final_state.inverse_mass == 1.0).all())

    def test_single_chain_fallback(self):
        spl = ChEESHMC(initial_trajectory_length=1.2, max_leapfrog=32)
        res = sample(_corr(), spl, 400, num_warmup=300, initial_params=torch.zeros(2), key=10)
        st = res.final_state
        assert float(st.log_traj_bar) == pytest.approx(np.log(1.2), abs=1e-6)
        assert float(st.log_eps_bar) != pytest.approx(np.log(0.1))
        assert np.abs(res.transitions.params.numpy().mean(axis=0)).max() < 0.35

    def test_split_run_equals_unsplit_across_warmup(self):
        """The torch engine's split run (warmup crossing the split) is exact."""
        spl = ChEESHMC(initial_step_size=0.05, max_leapfrog=16)
        kw = dict(key=11, num_chains=8, initial_params=torch.zeros(2))
        full = sample(_corr(), spl, 60, num_warmup=40, discard_initial=0, **kw)
        first = sample(_corr(), spl, 16, num_warmup=40, discard_initial=0, **kw)
        rest = sample(_corr(), spl, 44, num_warmup=25, discard_initial=1,
                      initial_state=first.final_state, iteration_offset=15, **kw)
        assert torch.equal(torch.cat([first.transitions.lp, rest.transitions.lp], 1),
                           full.transitions.lp)
        assert torch.equal(rest.final_state.log_traj_bar, full.final_state.log_traj_bar)


# ---- the fused engine on the plain versions ------------------------------------------


SPL = dict(initial_step_size=0.1, initial_trajectory_length=0.5, max_leapfrog=8)


def _adapted(st):
    return (float(torch.exp(st.log_eps_bar.reshape(-1)[0])),
            float(torch.exp(st.log_traj_bar.reshape(-1)[0])), st.inverse_mass[0].numpy())


def test_fused_chees_posterior_and_final_state():
    res = sample(_corr(), ChEESHMC(**SPL), 400, key=3, num_chains=1024, engine="fused",
                 num_warmup=300, discard_initial=300, initial_params=torch.zeros(2))
    draws = res.transitions.params.reshape(-1, 2).numpy()
    acc = float(res.transitions.accepted.float().mean())
    assert 0.4 < acc < 0.95
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.06)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.15)
    st = res.final_state
    assert bool(torch.isfinite(st.log_eps_bar).all() and torch.isfinite(st.log_traj_bar).all())
    assert tuple(st.inner.params.shape) == (1024, 2)
    for leaf in (st.log_eps_bar, st.log_traj_bar):
        assert float(leaf.max() - leaf.min()) < 1e-6
    assert float((st.inverse_mass.amax(0) - st.inverse_mass.amin(0)).max()) < 1e-6
    np.testing.assert_allclose(st.inverse_mass[0].numpy(), np.diag(COV), rtol=0.3)


@pytest.mark.parametrize("C", [1024, 1000])
def test_fused_warmup_matches_torch_engine_warmup(C):
    """The fused warmup lands the torch engine's adapted regime (the JAX
    test's bands); at a ragged count the Welford count is the real C·W."""
    kw = dict(key=9, num_chains=C, initial_params=torch.zeros(2), num_warmup=400,
              discard_initial=400, thinning=1)
    tr_f, st_f = sample_fused_chees(_corr(), ChEESHMC(**SPL), 300, warmup_engine="fused", **kw)
    tr_t, st_t = sample_fused_chees(_corr(), ChEESHMC(**SPL), 300, warmup_engine="torch", **kw)
    eps_f, t_f, minv_f = _adapted(st_f)
    eps_t, t_t, minv_t = _adapted(st_t)
    assert 0.6 < eps_f / eps_t < 1.6
    assert 0.4 < t_f / t_t < 2.5
    np.testing.assert_allclose(minv_f, minv_t, rtol=0.35)
    assert abs(float(st_f.n[0]) - C * 400) < 1
    assert tuple(tr_f.params.shape) == (C, 300, 2)
    for tr in (tr_f, tr_t):
        draws = tr.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.08)
        np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.2)


def test_fused_warmup_adapt_mass_off_and_thinning():
    res = sample(_corr(), ChEESHMC(**SPL, adapt_mass=False), 200, key=22, num_chains=1024,
                 engine="fused", num_warmup=300, discard_initial=300, thinning=2,
                 initial_params=torch.zeros(2))
    assert bool((res.final_state.inverse_mass == 1.0).all())
    assert tuple(res.transitions.params.shape) == (1024, 200, 2)
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.06)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.16)


def test_fused_warmup_bad_init_ratio_recovers():
    spl = ChEESHMC(initial_step_size=0.01, initial_trajectory_length=0.01, max_leapfrog=16)
    clock = {}
    tr, st = sample_fused_chees(_corr(), spl, 200, key=3, num_chains=4096,
                                initial_params=torch.zeros(2), num_warmup=500,
                                discard_initial=500, thinning=1, stage_clock=clock)
    eps, t_bar, _ = _adapted(st)
    assert len(clock["attempts"]) > 1  # the consistency loop re-staged
    assert t_bar / eps < 8.0
    assert 0.5 < eps < 3.0
    draws = tr.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.06)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.16)


def test_fused_split_after_warmup_is_bit_exact():
    kw = dict(key=13, num_chains=256, engine="fused")
    whole = sample(_corr(), ChEESHMC(**SPL), 64, num_warmup=100, discard_initial=100,
                   initial_params=torch.zeros(2), **kw)
    first = sample(_corr(), ChEESHMC(**SPL), 32, num_warmup=100, discard_initial=100,
                   initial_params=torch.zeros(2), **kw)
    rest = sample(_corr(), ChEESHMC(**SPL), 32, num_warmup=0, discard_initial=1,
                  initial_state=first.final_state, iteration_offset=132, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))
    assert torch.equal(rest.final_state.inner.gradient, whole.final_state.inner.gradient)


def test_fused_errors():
    m = _corr()
    kw = dict(key=0, num_chains=64, engine="fused", initial_params=torch.zeros(2))
    with pytest.raises(ValueError, match="discard_initial == num_warmup"):
        sample(m, ChEESHMC(), 10, num_warmup=20, discard_initial=5, **kw)
    with pytest.raises(ValueError, match="num_warmup >= 1"):
        sample(m, ChEESHMC(), 10, num_warmup=0, discard_initial=0, **kw)
    first = sample(m, ChEESHMC(**SPL), 16, num_warmup=20, discard_initial=20, **kw)
    with pytest.raises(ValueError, match="chunk-resume schedule"):
        sample(m, ChEESHMC(**SPL), 8, num_warmup=20, discard_initial=20,
               initial_state=first.final_state, **kw)
    with pytest.raises(ValueError, match="warmup_engine"):
        sample_fused_chees(m, ChEESHMC(), 8, key=0, num_chains=64, initial_params=torch.zeros(2),
                           num_warmup=8, discard_initial=8, thinning=1, warmup_engine="xla")
    # a per-chain (single-chain fallback) state has no shared statistics
    st = first.final_state
    bad = type(st)(**{**st.__dict__, "log_eps_bar": st.log_eps_bar + torch.linspace(0, 1, 64)})
    with pytest.raises(ValueError, match="replicated"):
        chees_frozen_stage(ChEESHMC(), bad, 2)


def test_fused_tile_rule_matches_jax():
    for C, max_tile, d, budget in ((8192, 4096, 32, 2 << 20), (8192, 4096, 10, 2 << 20),
                                   (8192, 4096, 2, 2 << 20), (8192, 4096, 32, 4 << 20),
                                   (8192, 4096, 10, 4 << 20), (1000, 4096, 2, 2 << 20),
                                   (2048, 1024, 2, 4 << 20)):
        want = ref_fused._fused_tiling(C, max_tile, None, "chains", d=d, vmem_budget=budget)[1]
        assert fused_tile(C, max_tile, d, budget) == want


def test_jax_state_resumes_in_the_port():
    """A ChEES state from a small JAX warmup (XLA on CPU), carried across as
    numpy arrays, stages the same frozen launch: R, ε̄ and the M⁻¹ column."""
    jm = ref.models.targets.correlated_gaussian_model(COV)
    jspl = ref.ChEESHMC(**SPL)
    res = ref.sample(jm, jspl, 4, key=jax.random.key(2), num_chains=32, num_warmup=60,
                     initial_params=jnp.zeros(2))
    jst = res.final_state
    a = lambda v: np.asarray(v)
    inner = gradient_transition_from_numpy(a(jst.inner.params), a(jst.inner.lp),
                                           a(jst.inner.gradient), a(jst.inner.accepted),
                                           device="cpu")
    pst = chees_state_from_numpy(inner, **{k: a(getattr(jst, k)) for k in FIELDS}, device="cpu")
    R, eps, minv = chees_frozen_stage(ChEESHMC(**SPL), pst, 2)
    jR, jeps, jminv, *_ = ref_fused.chees_frozen_stage(jspl, jst, 2)
    assert R == jR
    assert float(eps[0]) == pytest.approx(float(jeps), rel=1e-6)
    _close(minv, jminv, 1e-6)
    out = sample(_corr(), ChEESHMC(**SPL), 8, key=3, num_chains=32, engine="fused",
                 num_warmup=0, discard_initial=1, initial_state=pst, iteration_offset=64)
    assert bool(torch.isfinite(out.transitions.params).all())
