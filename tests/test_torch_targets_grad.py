"""The port's target models and their hand-written gradients against the JAX
package: the flagship (μ, σ), the correlated Gaussian and the emcee model.

Tile densities are held at 1e-5 relative. Gradients are held against
``jax.vjp`` of the JAX tile density (what the fused JAX kernels use) at
1e-5 of the size of the terms that make them: the flagship's components are
differences of sums that nearly cancel near the posterior mode, so a bare
relative tolerance would measure cancellation, not the algebra.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedmh_tpu.models import targets as ref_targets
from advancedmh_tpu_torch.convert import (
    correlated_gaussian_from_numpy,
    emcee_demo_from_numpy,
    gaussian_mean_scale_from_numpy,
)
from advancedmh_tpu_torch.models import logdensity, logdensity_and_gradient, logdensity_batched

DATA = np.random.default_rng(1234).normal(size=30)
COVS = {
    "d2": np.array([[1.5, 0.35], [0.35, 1.0]]),
    "d4": 0.5 * np.ones((4, 4)) + 0.5 * np.eye(4),
}
F32_TENTH = float(np.float32(0.1))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _vjp(tile, p, *consts):
    lp, pull = jax.vjp(lambda x: tile(x, *consts), jnp.asarray(p))
    (g,) = pull(jnp.ones_like(lp))
    return np.asarray(lp), np.asarray(g)


def _flagship_points(rng, n=64):
    mu = rng.normal(size=n)
    sigma = rng.uniform(0.02, 3.0, size=n)
    edges = np.array([[0.3, -0.5], [0.3, -1e-7], [0.3, 0.0], [-0.2, 0.05],
                      [0.1, F32_TENTH], [0.1, np.nextafter(np.float32(0.1), 1)],
                      [0.0, np.nextafter(np.float32(0.1), 0)], [0.5, 1.2]]).T
    return np.concatenate([np.stack([mu, sigma]), edges], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def flagship():
    return gaussian_mean_scale_from_numpy(DATA, device="cpu"), ref_targets.gaussian_mean_scale_model(data=DATA)


def test_flagship_tile_density_matches_jax(flagship):
    port, ref = flagship
    p = _flagship_points(np.random.default_rng(0))
    got = port.tile_density(_t(p), *port.tile_consts).numpy()
    want = np.asarray(ref.tile_density(jnp.asarray(p), jnp.asarray(ref.tile_consts[0])))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def test_flagship_value_and_grad_matches_jax_vjp(flagship):
    """Random points and the σ edges: σ < 0 (both components 0), 0 ≤ σ < 0.1
    (the σ component 0), σ = 0.1 exactly (max splits the cotangent 0.5/0.5)
    and just above it."""
    port, ref = flagship
    p = _flagship_points(np.random.default_rng(1))
    lp, g = port.tile_value_and_grad(_t(p), *port.tile_consts)
    want_lp, want_g = _vjp(ref.tile_density, p, jnp.asarray(ref.tile_consts[0]))
    lp, g = lp.numpy(), g.numpy()
    np.testing.assert_array_equal(np.isneginf(lp), np.isneginf(want_lp))
    fin = np.isfinite(want_lp)
    np.testing.assert_allclose(lp[fin], want_lp[fin], rtol=1e-5)
    # scale of the terms each component is made of (float64)
    x = DATA[:, None]
    m = np.maximum(p[1].astype(np.float64), 0.1)
    z = (x - p[0]) / m
    scale_mu = np.abs(z).sum(0) / m + 1.0
    scale_sigma = (30 * m + np.abs(z * (x - p[0])).sum(0)) / (m * m) + 1.0
    assert np.all(np.abs(g[0] - want_g[0]) <= 1e-5 * scale_mu)
    assert np.all(np.abs(g[1] - want_g[1]) <= 1e-5 * scale_sigma)
    # the edges by name
    edge = p.shape[1] - 8
    assert np.all(g[:, edge:edge + 2] == 0.0)  # σ < 0
    assert g[1, edge + 2] == 0.0 and g[1, edge + 3] == 0.0 and g[1, edge + 6] == 0.0
    assert g[0, edge + 2] != 0.0
    assert want_g[1, edge + 4] != 0.0
    np.testing.assert_allclose(g[1, edge + 4], 0.5 * g[1, edge + 5], rtol=1e-3)


def test_flagship_autograd_model_gradient_matches_hand_written(flagship):
    """The per-chain autograd gradient (torch engine) agrees with the tile's
    hand-written one away from the σ = 0.1 kink."""
    port, _ = flagship
    p = _flagship_points(np.random.default_rng(2))[:, :64]
    _, g = port.tile_value_and_grad(_t(p), *port.tile_consts)
    for c in range(0, 64, 8):
        _, g_auto = logdensity_and_gradient(port, _t(p[:, c]))
        np.testing.assert_allclose(g_auto.numpy(), g[:, c].numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", sorted(COVS))
def test_correlated_tile_and_gradient_match_jax(name):
    cov = COVS[name]
    d = cov.shape[0]
    port = correlated_gaussian_from_numpy(cov, device="cpu")
    ref = ref_targets.correlated_gaussian_model(jnp.asarray(cov, jnp.float32))
    x = (np.random.default_rng(d).normal(size=(d, 128)) * 2).astype(np.float32)
    lp, g = port.tile_value_and_grad(_t(x), *port.tile_consts)
    want_lp, want_g = _vjp(ref.tile_density, x, jnp.asarray(ref.tile_consts[0]))
    np.testing.assert_allclose(lp.numpy(), want_lp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port.tile_density(_t(x), *port.tile_consts).numpy(),
                               want_lp, rtol=1e-5, atol=1e-5)
    # the gradient is -P x, and the per-chain forms agree with JAX's
    np.testing.assert_allclose(g.numpy(), -np.linalg.inv(cov) @ x, rtol=1e-4, atol=1e-4)
    got_b = logdensity_batched(port, _t(x.T)).numpy()
    want_b = np.asarray(jax.vmap(ref.logdensity_fn)(jnp.asarray(x.T)))
    np.testing.assert_allclose(got_b, want_b, rtol=1e-5, atol=1e-5)
    lp1, g1 = port.logdensity_and_gradient_fn(_t(x[:, 0]))
    want1 = ref.logdensity_and_gradient_fn(jnp.asarray(x[:, 0]))
    np.testing.assert_allclose(float(lp1), float(want1[0]), rtol=1e-5)
    np.testing.assert_allclose(g1.numpy(), np.asarray(want1[1]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transformed", [False, True])
def test_emcee_demo_tile_and_logprob_match_jax(transformed):
    port = emcee_demo_from_numpy(transformed, device="cpu")
    ref = ref_targets.emcee_demo_model(transformed=transformed)
    rng = np.random.default_rng(7)
    lo = -2.0 if transformed else -0.5
    x = np.stack([rng.uniform(lo, 5.0, 200), rng.normal(1.0, 2.0, 200)]).astype(np.float32)
    got = port.tile_density(_t(x)).numpy()
    want = np.asarray(ref.tile_density(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if not transformed:
        assert np.all(got[0, x[0] <= 0] == np.float32(-1e30))
        assert port.cuda_density == "emcee_demo"
    for c in range(0, 200, 13):
        lp = float(logdensity(port, _t(x[:, c])))
        want_lp = float(ref.logdensity_fn(jnp.asarray(x[:, c])))
        if np.isinf(want_lp):
            assert lp == want_lp
        else:
            np.testing.assert_allclose(lp, want_lp, rtol=1e-5)
