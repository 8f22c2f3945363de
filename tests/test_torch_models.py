"""The flagship (μ, σ) model of advancedmh_tpu_torch against advancedmh_tpu.

Both models are built on the same 30 observations. Densities and
gradients are deterministic: rtol 1e-5 in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedmh_tpu.models.targets import gaussian_mean_scale_model as ref_model
from advancedmh_tpu_torch import DensityModel, Normal, guarded_logdensity
from advancedmh_tpu_torch.convert import gaussian_mean_scale_from_numpy
from advancedmh_tpu_torch.models import (
    gaussian_mean_scale_model,
    logdensity,
    logdensity_and_gradient,
    logdensity_batched,
)

RTOL = 1e-5
DATA = np.random.default_rng(1234).normal(size=30)


@pytest.fixture(scope="module")
def models():
    return gaussian_mean_scale_from_numpy(DATA, device="cpu"), ref_model(data=DATA)


@pytest.fixture
def thetas():
    rng = np.random.default_rng(99)
    return np.stack(
        [rng.normal(size=64), rng.uniform(0.05, 3.0, size=64)], axis=1
    ).astype(np.float32)


def test_default_data_matches_reference():
    p = gaussian_mean_scale_model(device="cpu")
    np.testing.assert_array_equal(
        p.tile_consts[0].numpy().ravel(), DATA.astype(np.float32)
    )
    assert p.cuda_density == "gaussian_mean_scale" and p.dimension == 2


def test_logdensity_single(models, thetas):
    p, r = models
    for th in thetas[:16]:
        got = float(logdensity(p, torch.as_tensor(th)))
        want = float(r.logdensity_fn(jnp.asarray(th)))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_logdensity_batched(models, thetas):
    p, r = models
    got = logdensity_batched(p, torch.as_tensor(thetas)).numpy()
    want = np.asarray(jax.vmap(r.logdensity_fn)(jnp.asarray(thetas)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_default_batched_density_is_vmap(models, thetas):
    """A model without its own batched form gets torch.func.vmap."""
    p, r = models
    plain = DensityModel(p.logdensity_fn, device="cpu")
    got = logdensity_batched(plain, torch.as_tensor(thetas)).numpy()
    want = np.asarray(jax.vmap(r.logdensity_fn)(jnp.asarray(thetas)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_gradient_matches_jax_grad(models, thetas):
    p, r = models
    value_and_grad = jax.jit(jax.value_and_grad(r.logdensity_fn))
    for th in thetas[:8]:
        lp, g = logdensity_and_gradient(p, torch.as_tensor(th))
        want_lp, want_g = value_and_grad(jnp.asarray(th))
        np.testing.assert_allclose(float(lp), float(want_lp), rtol=RTOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)


def test_out_of_support_is_minus_inf_with_finite_gradient(models):
    p, r = models
    th = torch.tensor([0.3, -0.5])
    lp, g = logdensity_and_gradient(p, th)
    assert float(lp) == -np.inf
    assert bool(torch.isfinite(g).all())
    want = jax.grad(r.logdensity_fn)(jnp.asarray([0.3, -0.5]))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-6)


def test_guard_needs_the_double_where():
    """Without the safe-params substitution the gradient is NaN."""
    def build(safe):
        return DensityModel(guarded_logdensity(
            support_fn=lambda t: t[1] >= 0,
            logdensity_fn=lambda t: Normal(t[0], t[1]).log_prob(torch.tensor(0.5)),
            safe_params_fn=safe,
        ), device="cpu")

    at = torch.tensor([0.0, -1.0e-30])  # σ < 0 where log σ is NaN
    _, g = logdensity_and_gradient(
        build(lambda t: torch.stack([t[0], torch.clamp(t[1], min=0.1)])), at)
    assert bool(torch.isfinite(g).all())
    _, g_naive = logdensity_and_gradient(build(None), at)
    assert bool(torch.isnan(g_naive).any())


def test_tile_density_matches_jax(models, thetas):
    p, r = models
    tile = np.ascontiguousarray(thetas.T)  # (2, C)
    tile[1, :5] = [-0.5, -0.01, 0.0, 0.05, 0.1]  # guard and clamp edges
    got = p.tile_density(torch.as_tensor(tile), *p.tile_consts).numpy()
    want = np.asarray(r.tile_density(jnp.asarray(tile), jnp.asarray(r.tile_consts[0])))
    assert got.shape == want.shape == (1, tile.shape[1])
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL)


def test_model_device_is_explicit():
    m = gaussian_mean_scale_model(device="cpu")
    assert m.device == torch.device("cpu")
    assert m.tile_consts[0].device == torch.device("cpu")


def test_entry_points_default_to_the_card():
    """A model built with no device lives on the card; building one needs no
    CUDA memory (the constructors' defaults are read, nothing is built)."""
    import inspect

    from advancedmh_tpu_torch import RWMH, StaticMH, as_model, convert
    from advancedmh_tpu_torch.distributions import MvNormal
    from advancedmh_tpu_torch.models import correlated_gaussian_model, emcee_demo_model

    assert DensityModel(lambda x: -x @ x).device.type == "cuda"
    assert as_model(lambda x: -x @ x).device.type == "cuda"
    fns = [gaussian_mean_scale_model, correlated_gaussian_model, emcee_demo_model,
           MvNormal.standard, RWMH, StaticMH]
    fns += [getattr(convert, n) for n in dir(convert) if n.endswith("_from_numpy")]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
