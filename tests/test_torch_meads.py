"""MEADS in advancedmh_tpu_torch against advancedmh_tpu.

- ``_max_eig`` and ``ops/meads.py::max_eig_cols`` (d = 2 and 32, and the
  kernel-order ``pooled_max_eig``) against the JAX functions, and
  ``_fold_parameters``, ``_ghmc_fold`` / ``step_batched`` on JAX's own
  random numbers (1e-5);
- tests/test_meads.py's assertions on the torch engine, at their
  tolerances;
- the fused engine on the kernel's plain version (tests/test_pallas.py's
  MEADS checks at 1024 chains), split runs bit for bit, the errors, and a
  state carried across from the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.ops import pallas_meads
from advancedmh_tpu_torch import MEADS, DensityModel, sample
from advancedmh_tpu_torch.convert import correlated_gaussian_from_numpy, meads_state_from_numpy
from advancedmh_tpu_torch.models import gaussian_mean_scale_model
from advancedmh_tpu_torch.ops import max_eig_cols
from advancedmh_tpu_torch.ops.meads import pooled_max_eig

SIG = np.array([[1.5, 0.35], [0.35, 1.0]], np.float32)
SIG2 = np.array([[1.0, 0.5], [0.5, 1.0]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _corr(cov=SIG):
    return correlated_gaussian_from_numpy(cov, device="cpu")


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [2, 32])
def test_max_eig_matches_jax(d):
    rng = np.random.default_rng(d)
    v = (rng.normal(size=(d, 300)) * rng.uniform(0.3, 3.0, size=(d, 1))).astype(np.float32)
    want = float(pallas_meads._max_eig_cols(jnp.asarray(v)))
    _close(float(max_eig_cols(_t(v))), want)
    _close(float(pooled_max_eig(_t(v)[None])[0]), want)
    _close(float(MEADS._max_eig(_t(v.T))), float(ref.MEADS._max_eig(jnp.asarray(v.T))))


def test_fold_parameters_match_jax():
    rng = np.random.default_rng(1)
    xb = (rng.normal(size=(64, 3)) * [5.0, 1.0, 0.2]).astype(np.float32)
    gb = rng.normal(size=(64, 3)).astype(np.float32)
    for kw in (dict(), dict(diagonal_preconditioning=False, damping_slowdown=3.0),
               dict(step_size_clip=0.05)):
        for it in (1, 7, 400):
            got = MEADS(**kw)._fold_parameters(_t(xb), _t(gb), torch.tensor(it))
            want = ref.MEADS(**kw)._fold_parameters(jnp.asarray(xb), jnp.asarray(gb),
                                                    jnp.asarray(it, jnp.int32))
            for a, b in zip(got, want):
                _close(a, b)


@pytest.mark.parametrize("accept", ["nonreversible", "metropolis"])
def test_steps_match_jax_on_its_noise(accept):
    rng = np.random.default_rng(2)
    C, d, K = 48, 2, 4
    jm = ref.models.targets.correlated_gaussian_model(SIG)
    jspl, pspl = ref.MEADS(accept=accept), MEADS(accept=accept)
    x = rng.normal(size=(C, d)).astype(np.float32)
    lp, g = jax.vmap(jm.logdensity_and_gradient_fn)(jnp.asarray(x))
    p = rng.normal(size=(C, d)).astype(np.float32)
    u = rng.uniform(size=C).astype(np.float32)
    st = dict(x=x, lp=np.asarray(lp), grad=np.asarray(g), p=p, u=u,
              iteration=np.ones(C, np.int32), isaccept=np.ones(C, bool))
    jst = ref.samplers.meads.MEADSState(**{k: jnp.asarray(v) for k, v in st.items()})
    pst = meads_state_from_numpy(**st, device="cpu")
    for i in range(3):
        key = jax.random.fold_in(jax.random.key(5), i)
        zs, es = [], []
        for k in range(K):
            k_z, k_e = jax.random.split(jax.random.fold_in(key, k))
            zs.append(_t(jax.random.normal(k_z, (C // K, d), jnp.float32)))
            es.append(_t(jax.random.exponential(k_e, (C // K,))))
        _, jst = jspl.step_batched(key, jst, jm, (C,))
        _, pst = pspl.step_batched_from_noise(pst, _corr(), (C,), zs, es)
        assert np.array_equal(pst.isaccept.numpy(), np.asarray(jst.isaccept))
        for f in ("x", "lp", "grad", "p", "u"):
            _close(getattr(pst, f), getattr(jst, f))
        assert np.array_equal(pst.iteration.numpy(), np.asarray(jst.iteration))


# ---- tests/test_meads.py on the torch engine ------------------------------------------


class TestMEADSTorchEngine:
    def test_correlated_gaussian_moments(self):
        res = sample(_corr(), MEADS(), 800, key=0, num_chains=512, discard_initial=300,
                     initial_params=torch.zeros(2))
        d = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(d.mean(0), np.zeros(2), atol=0.06)
        np.testing.assert_allclose(np.cov(d.T), SIG, rtol=0.1, atol=0.05)

    def test_anisotropic_preconditioning(self):
        res = sample(_corr(np.diag([100.0, 1.0])), MEADS(), 1000, key=1, num_chains=512,
                     discard_initial=600, initial_params=torch.zeros(2))
        d = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(d.var(0), np.array([100.0, 1.0]), rtol=0.15)

    def test_readme_model_with_support_guard(self):
        res = sample(gaussian_mean_scale_model(device="cpu"), MEADS(), 500, key=2,
                     num_chains=256, discard_initial=300, initial_params=torch.tensor([0.0, 1.0]))
        d = res.transitions.params.reshape(-1, 2).numpy()
        assert np.isfinite(d).all()
        assert abs(d[:, 0].mean()) < 0.1
        assert abs(d[:, 1].mean() - 1.0) < 0.1

    def test_metropolis_accept_variant(self):
        res = sample(_corr(SIG2), MEADS(accept="metropolis"), 800, key=3, num_chains=512,
                     discard_initial=300, initial_params=torch.zeros(2))
        d = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(np.cov(d.T), SIG2, rtol=0.1, atol=0.05)

    def test_no_warmup_phase_and_errors(self):
        assert MEADS().has_warmup_phase is False
        with pytest.raises(ValueError, match="complementary chain folds"):
            sample(_corr(np.eye(2)), MEADS(), 10, key=0, initial_params=torch.zeros(2))
        with pytest.raises(ValueError, match="divisible by n_folds"):
            sample(_corr(np.eye(2)), MEADS(n_folds=4), 10, key=0, num_chains=6,
                   initial_params=torch.zeros(2))
        model = DensityModel(lambda p: -0.5 * (p["a"] ** 2 + p["b"] ** 2), device="cpu")
        with pytest.raises(ValueError, match="array params"):
            sample(model, MEADS(), 10, key=0, num_chains=8,
                   initial_params={"a": torch.zeros(()), "b": torch.zeros(())})
        with pytest.raises(ValueError, match="n_folds"):
            MEADS(n_folds=1)
        with pytest.raises(ValueError, match="accept"):
            MEADS(accept="bogus")

    def test_deterministic_slice_valid_and_split_exact(self):
        kw = dict(key=7, num_chains=64, initial_params=torch.zeros(2))
        a = sample(_corr(SIG2), MEADS(), 100, discard_initial=50, **kw)
        b = sample(_corr(SIG2), MEADS(), 100, discard_initial=50, **kw)
        assert torch.equal(a.transitions.params, b.transitions.params)
        u = a.final_state.u
        assert bool(((u >= 0.0) & (u < 1.0)).all())
        assert 0.6 < float(a.transitions.accepted.float().mean()) <= 1.0
        first = sample(_corr(SIG2), MEADS(), 40, discard_initial=50, **kw)
        rest = sample(_corr(SIG2), MEADS(), 60, discard_initial=1, iteration_offset=89,
                      initial_state=first.final_state, **kw)
        assert torch.equal(torch.cat([first.transitions.params, rest.transitions.params], 1),
                           a.transitions.params)


# ---- the fused engine on the plain version ------------------------------------------


def test_fused_meads_moments_and_slice():
    res = sample(_corr(), MEADS(), 600, key=0, num_chains=1024, engine="fused",
                 discard_initial=300, initial_params=torch.zeros(2))
    d = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(d.mean(0), np.zeros(2), atol=0.05)
    np.testing.assert_allclose(np.cov(d.T), SIG, rtol=0.08, atol=0.04)
    acc = float(res.transitions.accepted.float().mean())
    assert 0.8 < acc <= 1.0
    u = res.final_state.u
    assert bool(((u >= 0.0) & (u < 1.0)).all())
    assert int(res.final_state.iteration[0]) == 1 + 299 + 600


def test_fused_meads_thinning_and_two_folds():
    res = sample(_corr(np.diag([25.0, 1.0])), MEADS(n_folds=2), 300, key=1, num_chains=1024,
                 engine="fused", discard_initial=600, thinning=2, initial_params=torch.zeros(2))
    d = res.transitions.params.reshape(-1, 2).numpy()
    assert d.shape == (300 * 1024, 2)
    np.testing.assert_allclose(d.var(0), np.array([25.0, 1.0]), rtol=0.1)


@pytest.mark.parametrize("accept", ["nonreversible", "metropolis"])
def test_fused_split_runs_are_bit_exact(accept):
    kw = dict(key=2, num_chains=384, engine="fused", initial_params=torch.zeros(2))
    spl = MEADS(n_folds=3, accept=accept)
    whole = sample(_corr(SIG2), spl, 50, discard_initial=20, **kw)
    first = sample(_corr(SIG2), spl, 17, discard_initial=20, **kw)
    rest = sample(_corr(SIG2), spl, 33, discard_initial=1, initial_state=first.final_state, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))
    for f in ("x", "grad", "p", "u", "iteration"):
        assert torch.equal(getattr(rest.final_state, f), getattr(whole.final_state, f))


def test_fused_errors():
    with pytest.raises(ValueError, match="initial_params"):
        sample(_corr(), MEADS(), 10, key=0, num_chains=64, engine="fused")
    with pytest.raises(ValueError, match="divisible by n_folds"):
        sample(_corr(), MEADS(n_folds=4), 10, key=0, num_chains=130, engine="fused",
               initial_params=torch.zeros(2))
    with pytest.raises(ValueError, match="divisible by n_folds"):
        sample(_corr(), MEADS(n_folds=4), 10, key=0, num_chains=4, engine="fused",
               initial_params=torch.zeros(2))


def test_jax_state_resumes_in_the_port():
    jm = ref.models.targets.correlated_gaussian_model(SIG)
    res = ref.sample(jm, ref.MEADS(), 20, key=jax.random.key(4), num_chains=64,
                     initial_params=jnp.zeros(2))
    jst = res.final_state
    pst = meads_state_from_numpy(**{f: np.asarray(getattr(jst, f)) for f in
                                    ("x", "lp", "grad", "p", "u", "iteration", "isaccept")},
                                 device="cpu")
    assert int(pst.iteration[0]) == int(np.asarray(jst.iteration)[0])
    for engine in ("torch", "fused"):
        out = sample(_corr(), MEADS(), 30, key=5, num_chains=64, engine=engine,
                     discard_initial=1, initial_state=pst)
        assert bool(torch.isfinite(out.transitions.params).all())
        assert int(out.final_state.iteration[0]) == int(pst.iteration[0]) + 30
