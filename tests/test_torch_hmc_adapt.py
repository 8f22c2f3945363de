"""AdaptiveHMC in advancedmh_tpu_torch against advancedmh_tpu: ``_dual_avg``,
``_regularized_inverse_mass``, ``_welford_update`` and
``_welford_update_pooled`` on the same inputs (1e-6), the fused kernel's
plain version against the torch engine's frozen phase on the same noise,
tests/test_hmc.py's AdaptiveHMC tests at small sizes (same assertions), the
fused engine's validation errors (tests/test_fused_runtime.py), its
final-state reconstruction against the JAX formula, split runs of the
fused engine on its plain version (bit for bit), and tests/test_pallas.py's
fused AdaptiveHMC checks on the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.samplers.hmc_adapt import AdaptiveHMCState as RefState
from advancedmh_tpu_torch import AdaptiveHMC, AdaptiveHMCState, DensityModel, sample
from advancedmh_tpu_torch.convert import (
    adaptive_hmc_state_from_numpy,
    correlated_gaussian_from_numpy,
    gradient_transition_from_numpy,
)
from advancedmh_tpu_torch.ops import DualAveraging, adaptive_hmc_reference
from advancedmh_tpu_torch.ops.rwmh import step_noise

COV = np.asarray([[1.5, 0.35], [0.35, 1.0]], np.float32)
ANISO = np.diag([25.0, 1.0]).astype(np.float32)


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


# ---- the adaptation pieces against the JAX sampler ---------------------------------


def _states(rng, C=24, d=3):
    """The same random AdaptiveHMC statistics for both packages."""
    f = dict(
        log_eps=rng.normal(size=C), log_eps_bar=rng.normal(size=C),
        h_bar=rng.normal(scale=0.1, size=C), t=rng.integers(1, 50, size=C),
        mean=rng.normal(size=(C, d)), m2=rng.uniform(0.0, 30.0, size=(C, d)),
        n=rng.integers(0, 40, size=C).astype(np.float32),
        inverse_mass=rng.uniform(0.5, 2.0, size=(C, d)),
    )
    f = {k: (v.astype(np.int32) if k == "t" else v.astype(np.float32)) for k, v in f.items()}
    x = rng.normal(size=(C, d)).astype(np.float32)
    inner_j = ref.samplers.base.GradientTransition(jnp.asarray(x), jnp.zeros(C), jnp.asarray(x),
                                                   jnp.zeros(C, bool))
    jst = RefState(inner=inner_j, **{k: jnp.asarray(v) for k, v in f.items()})
    inner_p = gradient_transition_from_numpy(x, np.zeros(C), x, np.zeros(C, bool), device="cpu")
    pst = adaptive_hmc_state_from_numpy(inner_p, **f, device="cpu")
    return jst, pst, x


def test_adaptation_pieces_match_jax():
    rng = np.random.default_rng(3)
    jst, pst, x = _states(rng)
    kw = dict(target_accept=0.7, initial_step_size=0.3, mass_warm_start=12,
              mass_regularization=4.0)
    jspl, pspl = ref.AdaptiveHMC(**kw), AdaptiveHMC(**kw)
    acc = rng.uniform(size=24) < 0.5
    for a, b in zip(pspl._dual_avg(pst, torch.as_tensor(acc)),
                    jspl._dual_avg(jst, jnp.asarray(acc))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    got = pspl._regularized_inverse_mass(pst.m2, pst.n, pst.inverse_mass)
    want = jspl._regularized_inverse_mass(jst.mean, jst.m2, jst.n, jst.inverse_mass)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    for a, b in zip(pspl._welford_update(pst.mean, pst.m2, pst.n, _t(x)),
                    jspl._welford_update(jst.mean, jst.m2, jst.n, jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # the pooled merge starts from replicated moments, as a pooled state holds
    rep = {k: np.broadcast_to(np.asarray(getattr(jst, k))[:1], getattr(jst, k).shape)
           for k in ("mean", "m2", "n")}
    got = pspl._welford_update_pooled(_t(rep["mean"]), _t(rep["m2"]), _t(rep["n"]), _t(x), (24,))
    want = jspl._welford_update_pooled(jnp.asarray(rep["mean"]), jnp.asarray(rep["m2"]),
                                       jnp.asarray(rep["n"]), jnp.asarray(x), (24,))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# ---- the plain kernel version against the torch engine -------------------------


def test_plain_version_frozen_phase_matches_torch_engine():
    """The resume (frozen) variant of the plain version and the torch
    engine's frozen step at the same per-chain ε̄ and M⁻¹ on the same noise:
    every decision equal, states and lp within 1e-5."""
    m = _corr()
    C, n = 48, 10
    rng = np.random.default_rng(8)
    x0 = _t(rng.normal(size=(2, C)))
    leb = _t(np.log(rng.uniform(0.2, 0.6, size=(1, C))))
    minv = _t(rng.uniform(0.5, 2.0, size=(2, C)))
    lp0, g0 = m.tile_value_and_grad(x0, *m.tile_consts)
    out = adaptive_hmc_reference(m.tile_value_and_grad, m.cuda_density, x0, lp0, g0,
                                 m.tile_consts, 17, n_leapfrog=6, warmup=0, thin=1,
                                 n_samples=n, log_eps_bar=leb, inverse_mass=minv,
                                 iteration_offset=40)
    samples, lps, accs, leb_out, minv_out, _ = out
    assert torch.equal(leb_out, leb) and torch.equal(minv_out, minv)
    spl = AdaptiveHMC(n_leapfrog=6)._hmc(torch.exp(leb[0]), minv.T)
    z, logu = step_noise(17, 41, n, C, 2, "cpu")
    state, _ = spl.init_batched(None, m, (C,), x0.T.contiguous(), True)
    for t in range(n):
        state, _ = spl.step_from_noise(state, m, z[t].T, -logu[t], (C,))
        assert torch.equal(state.accepted, accs[t, 0] > 0.5)
        np.testing.assert_allclose(state.params.numpy(), samples[t].T.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(state.lp.numpy(), lps[t, 0].numpy(), rtol=1e-5, atol=1e-5)


def test_plain_version_warmup_adapts_as_the_formulas_say():
    """The plain version's warmup, replayed with the pieces: M⁻¹ from
    reg(M2, t − 1) of the positions it emitted, ε̄ = exp(log ε̄)."""
    m = _corr(ANISO)
    C = 64
    x0 = torch.zeros(2, C)
    lp0, g0 = m.tile_value_and_grad(x0, *m.tile_consts)
    args = (m.tile_value_and_grad, m.cuda_density, x0, lp0, g0, m.tile_consts, 5)
    kw = dict(n_leapfrog=5, thin=1, da=DualAveraging(0.1, 0.65), mass_warm_start=10)
    whole = adaptive_hmc_reference(*args, warmup=0, n_samples=30, **kw)
    # with warmup=0 the fresh variant never adapts: identity mass, ε = ε₀
    assert torch.equal(whole[4], torch.ones(2, C))
    assert torch.allclose(whole[3], torch.full((1, C), float(np.log(np.float32(0.1)))))
    warm = adaptive_hmc_reference(*args, warmup=30, n_samples=5, **kw)
    assert warm[4].shape == (2, C) and bool((warm[4] != 1.0).all())
    assert bool(torch.isfinite(warm[0]).all())


# ---- tests/test_hmc.py::TestAdaptiveHMC at small sizes ----------------------------


def _aniso_model():
    var = torch.tensor([25.0, 0.25])
    return DensityModel(lambda x: -0.5 * torch.sum(x * x / var), device="cpu"), var


class TestAdaptiveHMC:
    def test_validation(self):
        with pytest.raises(ValueError, match="n_leapfrog"):
            AdaptiveHMC(n_leapfrog=0)
        with pytest.raises(ValueError, match="target_accept"):
            AdaptiveHMC(target_accept=1.5)
        with pytest.raises(ValueError, match="gamma"):
            AdaptiveHMC(gamma=0.0)
        with pytest.raises(ValueError, match="mass_regularization"):
            AdaptiveHMC(mass_regularization=-1.0)
        with pytest.raises(ValueError, match="mass_warm_start"):
            AdaptiveHMC(mass_warm_start=-1)

    def test_mass_matrix_recovers_scales(self):
        model, var = _aniso_model()
        res = sample(model, AdaptiveHMC(n_leapfrog=10), 250, key=10, num_chains=64,
                     num_warmup=400, initial_params=torch.zeros(2))
        inv_mass = res.final_state.inverse_mass.mean(0).numpy()
        assert np.allclose(inv_mass, var.numpy(), rtol=0.35)
        x = res.transitions.params.numpy()
        assert np.allclose(x.var(axis=(0, 1)), var.numpy(), rtol=0.3)
        assert np.abs(x.mean(axis=(0, 1)) / np.sqrt(var.numpy())).max() < 0.1

    def test_pooled_mass_shared_and_faster(self):
        model, var = _aniso_model()
        short = 60
        res = sample(model, AdaptiveHMC(n_leapfrog=10, pooled=True), 20, key=11,
                     num_chains=128, num_warmup=short, initial_params=torch.zeros(2))
        im = res.final_state.inverse_mass.numpy()
        assert np.allclose(im, im[:1], atol=0.0)
        assert np.allclose(im[0], var.numpy(), rtol=0.5)
        res_pc = sample(model, AdaptiveHMC(n_leapfrog=10, pooled=False), 20, key=11,
                        num_chains=128, num_warmup=short, initial_params=torch.zeros(2))
        im_pc = res_pc.final_state.inverse_mass.mean(0).numpy()

        def err(est):
            return np.abs(np.log(est) - np.log(var.numpy())).max()

        assert err(im[0]) < err(im_pc)

    def test_frozen_after_warmup(self):
        model, _ = _aniso_model()
        res = sample(model, AdaptiveHMC(n_leapfrog=5), 30, key=12, num_chains=8,
                     num_warmup=60, initial_params=torch.zeros(2), collect_states=True)
        im = res.states.inverse_mass.numpy()  # (C, S, d)
        assert np.all(im[:, 1:] == im[:, :1])
        eps = res.states.log_eps_bar.numpy()
        assert np.all(eps[:, 1:] == eps[:, :1])

    def test_acceptance_near_target(self):
        res = sample(_corr(), AdaptiveHMC(n_leapfrog=5, initial_step_size=0.02), 400,
                     key=13, num_chains=32, num_warmup=600, initial_params=torch.zeros(2))
        assert abs(float(res.transitions.accepted.float().mean()) - 0.65) < 0.17
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert np.abs(np.cov(draws.T) - COV).max() < 0.25

    def test_pytree_params_mass(self):
        def logdensity(p):
            return -0.5 * (torch.sum(p["a"] ** 2 / 9.0) + torch.sum((p["b"] - 1.0) ** 2) / 0.25)

        res = sample(DensityModel(logdensity, device="cpu"), AdaptiveHMC(n_leapfrog=8), 20,
                     key=14, num_chains=32, num_warmup=300,
                     initial_params={"a": torch.zeros(2), "b": torch.zeros(())})
        im_a = res.final_state.inverse_mass["a"].mean(0).numpy()
        im_b = float(res.final_state.inverse_mass["b"].mean())
        assert np.allclose(im_a, 9.0, rtol=0.4)
        assert abs(im_b - 0.25) < 0.12


# ---- the fused engine ----------------------------------------------------------------


class TestFusedValidation:
    """tests/test_fused_runtime.py::TestFusedDispatchGuards for AdaptiveHMC."""

    def test_schedule_rejected(self):
        with pytest.raises(ValueError, match="discard_initial"):
            sample(_corr(np.eye(2)), AdaptiveHMC(), 10, key=0, num_chains=1024,
                   engine="fused", num_warmup=20, discard_initial=0,
                   initial_params=torch.zeros(2))
        with pytest.raises(ValueError, match="num_warmup >= 1"):
            sample(_corr(np.eye(2)), AdaptiveHMC(), 10, key=0, num_chains=8,
                   engine="fused", num_warmup=0, initial_params=torch.zeros(2))
        with pytest.raises(ValueError, match="initial parameters"):
            sample(_corr(np.eye(2)), AdaptiveHMC(), 10, key=0, num_chains=8,
                   engine="fused", num_warmup=5)

    def test_resume_needs_chunk_schedule(self):
        spl = AdaptiveHMC(n_leapfrog=3)
        res = sample(_corr(np.eye(2)), spl, 5, key=0, num_chains=4, num_warmup=10,
                     discard_initial=10, initial_params=torch.zeros(2))
        with pytest.raises(ValueError, match="chunk-resume"):
            sample(_corr(np.eye(2)), spl, 5, key=0, num_chains=4, engine="fused",
                   initial_state=res.final_state, num_warmup=3, discard_initial=3)

    def test_pooled_per_chain_state_rejected(self):
        per_chain = AdaptiveHMC(n_leapfrog=3)
        res = sample(_corr(np.eye(2)), per_chain, 5, key=0, num_chains=4, num_warmup=25,
                     discard_initial=25,
                     initial_params=torch.tensor([[0.1, -0.2], [0.4, 0.3], [-0.5, 0.2],
                                                  [0.2, 0.6]]),
                     initial_params_batched=True)
        with pytest.raises(ValueError, match="replicated"):
            sample(_corr(np.eye(2)), AdaptiveHMC(n_leapfrog=3, pooled=True), 5, key=0,
                   num_chains=4, engine="fused", initial_state=res.final_state,
                   num_warmup=0, discard_initial=1)

    def test_wrapper_checks_the_resume_pair(self):
        m = _corr()
        x = torch.zeros(2, 4)
        lp, g = m.tile_value_and_grad(x, *m.tile_consts)
        from advancedmh_tpu_torch.ops import fused_adaptive_hmc_sample

        with pytest.raises(ValueError, match="both"):
            fused_adaptive_hmc_sample(m.tile_value_and_grad, None, x, lp, g, m.tile_consts, 1,
                                      n_leapfrog=2, warmup=0, thin=1, n_samples=1,
                                      log_eps_bar=torch.zeros(1, 4))


def test_final_state_reconstruction_matches_jax_formula():
    """fused.py's reconstruction: log ε = log ε̄ = the kernel's log ε̄, h̄ = 0,
    t = num_warmup + 1, mean = the last draw, n = num_warmup, and M2 the
    regularised estimate inverted at n = num_warmup (fused.py:901-920)."""
    spl = AdaptiveHMC(n_leapfrog=4, initial_step_size=0.05)
    res = sample(_corr(ANISO), spl, 8, key=30, num_chains=32, engine="fused", num_warmup=40,
                 discard_initial=40, initial_params=torch.zeros(2))
    st = res.final_state
    assert isinstance(st, AdaptiveHMCState)
    im = st.inverse_mass.numpy()
    nn, r = 40.0, 5.0
    var = (im - 1e-3 * (r / (nn + r))) * ((nn + r) / nn)
    np.testing.assert_allclose(st.m2.numpy(), np.maximum(var, 0.0) * (nn - 1.0), rtol=1e-6)
    assert torch.equal(st.log_eps, st.log_eps_bar)
    assert bool((st.h_bar == 0).all()) and st.t.tolist() == [41] * 32
    assert torch.equal(st.mean, res.transitions.params[:, -1])
    assert st.n.tolist() == [40.0] * 32
    # the regularised estimate of the reconstructed M2 is the frozen M⁻¹
    back = spl._regularized_inverse_mass(st.m2, st.n, st.inverse_mass)
    np.testing.assert_allclose(back.numpy(), im, rtol=1e-5)


@pytest.mark.parametrize("pooled", [False, True])
def test_fused_split_run_is_bit_exact(pooled):
    """warmup + 2N in one call equals warmup + N, then N resumed frozen
    from the final state at its iteration offset."""
    m = _corr(ANISO)
    spl = AdaptiveHMC(n_leapfrog=4, initial_step_size=0.1, pooled=pooled)
    kw = dict(num_chains=32, engine="fused", key=6)
    whole = sample(m, spl, 24, num_warmup=30, discard_initial=30,
                   initial_params=torch.zeros(2), **kw)
    first = sample(m, spl, 12, num_warmup=30, discard_initial=30,
                   initial_params=torch.zeros(2), **kw)
    rest = sample(m, spl, 12, num_warmup=0, discard_initial=1, initial_state=first.final_state,
                  iteration_offset=30 + 12, **kw)
    assert torch.equal(torch.cat([first.transitions.params, rest.transitions.params], 1),
                       whole.transitions.params)
    assert torch.equal(torch.cat([first.transitions.lp, rest.transitions.lp], 1),
                       whole.transitions.lp)
    assert torch.equal(rest.final_state.inverse_mass, whole.final_state.inverse_mass)
    assert torch.equal(rest.final_state.inner.gradient, whole.final_state.inner.gradient)


@pytest.mark.parametrize("pooled", [False, True])
def test_fused_adaptive_hmc_on_the_plain_version(pooled):
    """tests/test_pallas.py::TestFusedAdaptiveHMC at 128 chains: the 25:1
    posterior, the mass estimate and a non-degenerate acceptance; pooled
    keeps one replicated M⁻¹."""
    res = sample(_corr(ANISO), AdaptiveHMC(n_leapfrog=8, initial_step_size=0.05, pooled=pooled),
                 300, key=30, num_chains=128, engine="fused", num_warmup=300,
                 discard_initial=300, initial_params=torch.zeros(2))
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0) / np.sqrt(np.diag(ANISO)), np.zeros(2), atol=0.1)
    np.testing.assert_allclose(np.cov(draws.T), ANISO, rtol=0.15, atol=0.1)
    im = res.final_state.inverse_mass.numpy()
    np.testing.assert_allclose(np.median(im, axis=0), np.diag(ANISO), rtol=0.5)
    if pooled:
        assert np.ptp(im, axis=0).max() < 1e-5
    acc = float(res.transitions.accepted.float().mean())
    assert 0.5 < acc < (0.99 if pooled else 0.95)
