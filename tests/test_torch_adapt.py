"""StepSizeAdaptation in advancedmh_tpu_torch against advancedmh_tpu: the HG14
update after a fixed accept sequence against the JAX sampler's
``step_warmup_batched`` (1e-6), the kernel's ``exp(−κ log t)`` form against
``t^−κ``, ``optimal_rwmh_accept``, tests/test_adapt.py's tests at small sizes
(the Barker family included), the fused engine's
family and schedule errors (tests/test_pallas.py, tests/test_fused_runtime.py)
and the fused dual-averaging engine on its plain version, a split run
included (bit for bit).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu_torch import (
    RWMH,
    MvNormal,
    RobustAdaptiveMetropolis,
    StepSizeAdaptation,
    StepSizeAdaptationState,
    sample,
)
from advancedmh_tpu_torch.convert import (
    correlated_gaussian_from_numpy,
    gaussian_mean_scale_from_numpy,
    step_size_adaptation_state_from_numpy,
    transition_from_numpy,
)
from advancedmh_tpu_torch.models import DensityModel
from advancedmh_tpu_torch.ops import DualAveraging, fused_adapt_rwmh_sample
from advancedmh_tpu_torch.ops.hmc_adapt import dual_average_step
from advancedmh_tpu_torch.samplers import optimal_rwmh_accept
from advancedmh_tpu_torch.utils import generator

SIG = np.array([[1.5, 0.35], [0.35, 1.0]], dtype=np.float32)
P = np.linalg.inv(SIG).astype(np.float32)
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


def _quadratic_model():
    Pt = torch.as_tensor(P)
    return DensityModel(lambda x: -0.5 * x @ Pt @ x, dimension=2, device="cpu"), SIG


class _Scripted:
    """An inner sampler whose warmup step accepts as a fixed table says."""

    def __init__(self, table, wrap):
        self.table, self.wrap = table, wrap

    def step_warmup_batched(self, key, inner, model, batch_shape):
        return types.SimpleNamespace(accepted=self.wrap(self.table[inner])), inner + 1


# ---- the dual-averaging arithmetic ------------------------------------------------


def test_hg14_update_matches_jax_after_fixed_accepts():
    rng = np.random.default_rng(0)
    table = rng.uniform(size=(60, 16)) < 0.4
    kw = dict(target_accept=0.3, initial_step_size=0.7)
    jspl = ref.StepSizeAdaptation(lambda eps: _Scripted(table, jnp.asarray), **kw)
    pspl = StepSizeAdaptation(lambda eps: _Scripted(table, torch.as_tensor), **kw)
    le = np.log(np.float32(0.7)) * np.ones(16, np.float32)
    jst = ref.samplers.adapt.StepSizeAdaptationState(
        inner=0, log_eps=jnp.asarray(le), log_eps_bar=jnp.asarray(le),
        h_bar=jnp.zeros(16), t=jnp.ones(16, jnp.int32))
    pst = StepSizeAdaptationState(inner=0, log_eps=torch.as_tensor(le),
                                  log_eps_bar=torch.as_tensor(le), h_bar=torch.zeros(16),
                                  t=torch.ones(16, dtype=torch.int32))
    for _ in range(60):
        _, jst = jspl.step_warmup_batched(jax.random.key(0), jst, None, (16,))
        _, pst = pspl.step_warmup_batched(None, pst, None, (16,))
    for f in ("log_eps", "log_eps_bar", "h_bar"):
        np.testing.assert_allclose(getattr(pst, f).numpy(), np.asarray(getattr(jst, f)),
                                   rtol=1e-6, atol=1e-6)
    assert pst.t.tolist() == np.asarray(jst.t).tolist() == [61] * 16


def test_kernel_form_of_the_update_matches_pow():
    """The kernels' t^−κ = exp(−κ·log t) and tensor-by-tensor division,
    against the JAX sampler's jnp.power form, over 200 steps."""
    rng = np.random.default_rng(1)
    acc = rng.uniform(size=(200, 1, 32)) < 0.5
    da = DualAveraging(2.0, 0.35)
    le = torch.full((1, 32), da.log_eps0)
    leb, hb = le.clone(), torch.zeros((1, 32))
    jle, jleb, jhb = (jnp.asarray(v.numpy()) for v in (le, leb, hb))
    mu = float(np.log(20.0))
    for t in range(1, 201):
        le, leb, hb = dual_average_step(t, torch.as_tensor(acc[t - 1]), le, leb, hb, da)
        a = jnp.asarray(acc[t - 1], jnp.float32)
        tf = jnp.float32(t)
        w = 1.0 / (tf + 10.0)
        jhb = (1.0 - w) * jhb + w * (0.35 - a)
        jle = mu - jnp.sqrt(tf) / 0.05 * jhb
        eta = jnp.power(tf, -0.75)
        jleb = eta * jle + (1.0 - eta) * jleb
    for got, want in ((le, jle), (leb, jleb), (hb, jhb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_optimal_rwmh_accept():
    for d in (1, 2, 3, 7, 10, 11, 32):
        assert optimal_rwmh_accept(d) == ref.samplers.adapt.optimal_rwmh_accept(d)
    assert StepSizeAdaptation.rwmh(2, device="cpu").target_accept == 0.352
    assert StepSizeAdaptation.rwmh(2, device="cpu")._fused_family == ("rwmh_iso", 2)
    assert StepSizeAdaptation.rwmh(40, target_accept=0.3, device="cpu").target_accept == 0.3


# ---- tests/test_adapt.py ------------------------------------------------------------


class TestValidation:
    def test_target_accept_range(self):
        with pytest.raises(ValueError, match="target_accept"):
            StepSizeAdaptation.rwmh(2, target_accept=1.5, device="cpu")

    def test_positive_step_size(self):
        with pytest.raises(ValueError, match="initial_step_size"):
            StepSizeAdaptation.rwmh(2, initial_step_size=0.0, device="cpu")

    def test_other_knobs(self):
        for kw, what in ((dict(gamma=0.0), "gamma"), (dict(t0=-1.0), "t0"),
                         (dict(kappa=1.5), "kappa")):
            with pytest.raises(ValueError, match=what):
                StepSizeAdaptation.rwmh(2, device="cpu", **kw)


class TestRWMHFamily:
    def test_acceptance_hits_target(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=10.0, device="cpu")
        res = sample(model, spl, 1500, key=0, num_chains=64, num_warmup=1000,
                     initial_params=torch.zeros(2))
        acc = float(res.transitions.accepted.float().mean())
        assert abs(acc - spl.target_accept) < 0.08
        fixed = sample(model, RWMH(MvNormal(torch.zeros(2), scale=10.0)), 1500, key=0,
                       num_chains=64, num_warmup=1000, initial_params=torch.zeros(2))
        acc_fixed = float(fixed.transitions.accepted.float().mean())
        assert acc_fixed < 0.05
        assert acc_fixed < acc - 0.08

    def test_posterior_moments(self):
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=2.0, device="cpu")
        chains = sample(MODEL, spl, 1500, key=1, num_chains=32, num_warmup=1000,
                        initial_params=torch.tensor([0.0, 1.0]), chain_type="chains",
                        param_names=["μ", "σ"])
        assert abs(float(chains["μ"].mean())) < 0.1
        assert abs(float(chains["σ"].mean()) - 1.0) < 0.1

    def test_step_size_frozen_after_warmup(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2, device="cpu")
        _, state = spl.init(generator(0, "cpu"), model, torch.zeros(2))
        for j in range(50):
            _, state = spl.step_warmup(generator(j, "cpu"), state, model)
        bar, t_warm = float(state.log_eps_bar), int(state.t)
        for j in range(50, 60):
            _, state = spl.step(generator(j, "cpu"), state, model)
        assert float(state.log_eps_bar) == bar
        assert int(state.t) == t_warm


class TestMALAFamily:
    def test_acceptance_hits_mala_target(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.mala(initial_step_size=3.0)
        res = sample(model, spl, 1000, key=2, num_chains=64, num_warmup=1000,
                     initial_params=torch.zeros(2))
        assert abs(float(res.transitions.accepted.float().mean()) - 0.574) < 0.08

    def test_covariance_recovery(self):
        model, SIG_ = _quadratic_model()
        spl = StepSizeAdaptation.mala(initial_step_size=0.1)
        res = sample(model, spl, 1500, key=3, num_chains=64, num_warmup=1000,
                     initial_params=torch.zeros(2))
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert np.abs(np.cov(draws.T) - SIG_).max() < 0.2


class TestBarkerFamily:
    def test_acceptance_hits_barker_target(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.barker(initial_step_size=5.0)
        res = sample(model, spl, 800, key=4, num_chains=64, num_warmup=1200,
                     initial_params=torch.zeros(2))
        assert abs(float(res.transitions.accepted.float().mean()) - 0.57) < 0.1


class TestPerChainAdaptation:
    def test_chains_adapt_independently(self):
        """Each chain carries its own (log ε, H̄): chains end in the sane
        RWMH band for this target, none stuck."""
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=1.0, device="cpu")
        res = sample(model, spl, 1, key=5, num_chains=8, num_warmup=800,
                     initial_params=torch.zeros(2))
        eps = torch.exp(res.final_state.log_eps_bar).numpy()
        assert eps.min() > 0.3 and eps.max() < 6.0
        assert eps.std() / eps.mean() < 0.5


class TestBatchedKernel:
    def test_batched_matches_single_chain_semantics(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=10.0, device="cpu")
        kw = dict(key=0, num_chains=16, num_warmup=1000, initial_params=torch.zeros(2))
        vec = sample(model, spl, 600, **kw)
        seq = sample(model, spl, 600, chain_method="sequential", **kw)
        for r in (vec, seq):
            assert abs(float(r.transitions.accepted.float().mean()) - spl.target_accept) < 0.08
        eps_v = torch.exp(vec.final_state.log_eps_bar).numpy()
        eps_r = torch.exp(seq.final_state.log_eps_bar).numpy()
        assert eps_v.shape == eps_r.shape == (16,)
        assert 0.7 < np.median(eps_v) / np.median(eps_r) < 1.4
        assert eps_v.std() / eps_v.mean() < 0.5

    def test_mala_family_batched_hits_target(self):
        model, SIG_ = _quadratic_model()
        spl = StepSizeAdaptation.mala(initial_step_size=3.0)
        res = sample(model, spl, 1500, key=2, num_chains=64, num_warmup=1000,
                     initial_params=torch.zeros(2))
        assert abs(float(res.transitions.accepted.float().mean()) - 0.574) < 0.08
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert np.abs(np.cov(draws.T) - SIG_).max() < 0.2

    def test_wrapped_ram_batched_keeps_inner_adaptation(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation(
            lambda eps: RobustAdaptiveMetropolis(
                S=torch.as_tensor(eps).reshape(torch.as_tensor(eps).shape + (1,))
                * torch.eye(2)),
            initial_step_size=0.5)
        res = sample(model, spl, 200, key=3, num_chains=8, num_warmup=300,
                     initial_params=torch.zeros(2))
        S = res.final_state.inner.S.numpy()
        assert S.shape == (8, 2, 2)
        assert np.abs(S[:, 1, 0]).max() > 1e-3


# ---- the fused engine ----------------------------------------------------------------


def _corr():
    return correlated_gaussian_from_numpy(SIG, device="cpu")


def test_fused_requires_the_rwmh_family():
    spl = StepSizeAdaptation(lambda eps: RWMH(MvNormal(torch.zeros(2), scale=eps)))
    with pytest.raises(ValueError, match="rwmh"):
        sample(MODEL, spl, 10, key=0, num_chains=256, engine="fused", num_warmup=10,
               discard_initial=10, initial_params=torch.tensor([0.0, 1.0]))


def test_fused_schedule_errors():
    spl = StepSizeAdaptation.rwmh(2, device="cpu")
    with pytest.raises(ValueError, match="discard_initial == num_warmup"):
        sample(_corr(), spl, 10, key=0, num_chains=8, engine="fused", num_warmup=20,
               discard_initial=0, initial_params=torch.zeros(2))
    res = sample(_corr(), spl, 5, key=0, num_chains=4, num_warmup=10, discard_initial=10,
                 initial_params=torch.zeros(2))
    with pytest.raises(ValueError, match="chunk-resume"):
        sample(_corr(), spl, 5, key=0, num_chains=4, engine="fused",
               initial_state=res.final_state, num_warmup=3, discard_initial=3)
    with pytest.raises(ValueError, match="initial_params"):
        sample(_corr(), spl, 5, key=0, num_chains=4, engine="fused", num_warmup=3)
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="warmup=0"):
        fused_adapt_rwmh_sample(_corr().tile_density, None, x, torch.zeros(1, 4),
                                _corr().tile_consts, 1, warmup=2, thin=1, n_samples=1,
                                log_eps_bar=torch.zeros(1, 4))


def test_fused_adapt_on_the_plain_version():
    """tests/test_pallas.py::TestFusedAdaptRWMH at 256 chains: from a 10×
    too-large ε the warmup pulls acceptance to the d = 2 optimum, the
    moments match and the per-chain ε̄ lands in the sane band."""
    spl = StepSizeAdaptation.rwmh(2, initial_step_size=10.0, device="cpu")
    res = sample(_corr(), spl, 1000, key=11, num_chains=256, engine="fused",
                 num_warmup=600, discard_initial=600, initial_params=torch.zeros(2))
    assert abs(float(res.transitions.accepted.float().mean()) - spl.target_accept) < 0.08
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.1)
    np.testing.assert_allclose(np.cov(draws.T), SIG, atol=0.15)
    eps = torch.exp(res.final_state.log_eps_bar).numpy()
    assert eps.shape == (256,)
    assert 0.5 < np.median(eps) < 4.0
    assert eps.std() / eps.mean() < 0.5
    assert res.final_state.t.tolist() == [601] * 256


def test_fused_adapt_split_run_is_bit_exact():
    """Warmup + 2N in one call equals warmup + N, then N resumed from the
    final state at its iteration offset (thinning 2)."""
    spl = StepSizeAdaptation.rwmh(2, initial_step_size=3.0, device="cpu")
    kw = dict(num_chains=48, engine="fused", key=4, thinning=2)
    whole = sample(MODEL, spl, 40, num_warmup=30, discard_initial=30,
                   initial_params=torch.tensor([0.0, 1.0]), **kw)
    first = sample(MODEL, spl, 20, num_warmup=30, discard_initial=30,
                   initial_params=torch.tensor([0.0, 1.0]), **kw)
    st = first.final_state
    moved = step_size_adaptation_state_from_numpy(
        transition_from_numpy(st.inner.params.numpy(), st.inner.lp.numpy(),
                              st.inner.accepted.numpy(), device="cpu"),
        st.log_eps.numpy(), st.log_eps_bar.numpy(), st.h_bar.numpy(), st.t.numpy(),
        device="cpu")
    rest = sample(MODEL, spl, 20, num_warmup=0, discard_initial=2, initial_state=moved,
                  iteration_offset=30 + 40, **kw)
    joined = torch.cat([first.transitions.params, rest.transitions.params], 1)
    assert torch.equal(joined, whole.transitions.params)
    assert torch.equal(torch.cat([first.transitions.lp, rest.transitions.lp], 1),
                       whole.transitions.lp)
    assert torch.equal(rest.final_state.log_eps_bar, whole.final_state.log_eps_bar)
    assert torch.equal(rest.final_state.t, first.final_state.t)
