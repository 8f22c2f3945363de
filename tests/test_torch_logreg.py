"""The logistic-regression target of advancedmh_tpu_torch against
advancedmh_tpu's: the synthetic data bit for bit, the tile density and its
hand-written gradient against the JAX tile density and ``jax.vjp`` at
256 x 32 (rtol 1e-5 on lp; gradients at 1e-5 of the size of the terms that
make them, since each component is a sum of terms of both signs), the
batched and per-chain forms, ``convert``, and the shared-memory size check
of the kernels' constants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedmh_tpu.models import targets as ref_targets
from advancedmh_tpu_torch.convert import logistic_regression_from_numpy
from advancedmh_tpu_torch.models import (
    logdensity,
    logdensity_and_gradient,
    logdensity_batched,
    logistic_regression_model,
)
from advancedmh_tpu_torch.ops import _build
from advancedmh_tpu_torch.ops.rwmh import flat_consts


@pytest.fixture(scope="module")
def pair():
    return (logistic_regression_model(256, 32, seed=0, device="cpu"),
            ref_targets.logistic_regression_model(256, 32, seed=0))


def _points(rng, port, d=32, n=48):
    """Coefficients around β_true and at the origin, plus a column whose
    first logit is exactly 0 and columns with logits near ±80."""
    X = port.tile_consts[0].numpy()
    b = rng.normal(scale=1.5, size=(d, n)).astype(np.float32)
    b[:, 0] = 0.0  # every z = 0 exactly
    b[:, 1] = port.beta_true
    b[:, 2] = 80.0 * X[0] / np.dot(X[0], X[0])  # z_0 = 80
    b[:, 3] = -b[:, 2]
    b[:, 4] = 0.0
    b[0, 4] = 1.0
    b[:, 4] -= X[0] * (X[0, 0] / np.dot(X[0], X[0]))  # z_0 = 0, others not
    return b.astype(np.float32)


def _vjp(ref, b):
    consts = tuple(jnp.asarray(c) for c in ref.tile_consts)
    lp, pull = jax.vjp(lambda x: ref.tile_density(x, *consts), jnp.asarray(b))
    (g,) = pull(jnp.ones_like(lp))
    return np.asarray(lp), np.asarray(g)


def test_data_equal_jax_bit_for_bit(pair):
    port, ref = pair
    X, y, inv_var = (c.numpy() for c in port.tile_consts)
    np.testing.assert_array_equal(X, np.asarray(ref.tile_consts[0]))
    np.testing.assert_array_equal(y, np.asarray(ref.tile_consts[1]))
    np.testing.assert_array_equal(port.beta_true, ref.beta_true)
    assert inv_var.shape == (1, 1) and inv_var[0, 0] == np.float32(0.01)
    assert port.cuda_density == "logistic_regression" and port.dimension == 32


@pytest.mark.parametrize("seed", [0, 7])
def test_tile_value_and_grad_match_jax_vjp(pair, seed):
    port, ref = pair
    b = _points(np.random.default_rng(seed), port)
    lp_ref, g_ref = _vjp(ref, b)
    lp, g = port.tile_value_and_grad(torch.as_tensor(b), *port.tile_consts)
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5)
    np.testing.assert_allclose(port.tile_density(torch.as_tensor(b), *port.tile_consts).numpy(),
                               lp.numpy(), rtol=0, atol=0)
    # the size of the terms behind each gradient component: Σ_i |X_ij|·1 + |b_j|/100
    X = port.tile_consts[0].numpy()
    scale = np.abs(X).sum(0)[:, None] + 0.01 * np.abs(b)
    assert np.all(np.abs(g.numpy() - g_ref) <= 1e-5 * scale)


def test_gradient_at_zero_logit_is_jax_reverse_mode(pair):
    """At z = 0 JAX's reverse mode gives softplus' = ½ (maximum's split) −
    ½ (abs' = +1 at 0) = 0, not σ(0) = ½; the port matches it."""
    port, ref = pair
    b = np.zeros((32, 1), np.float32)
    _, g_ref = _vjp(ref, b)
    _, g = port.tile_value_and_grad(torch.as_tensor(b), *port.tile_consts)
    y = port.tile_consts[1].numpy()[:, 0]
    want = port.tile_consts[0].numpy().T @ y
    np.testing.assert_allclose(g.numpy()[:, 0], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-5, atol=1e-5)


def test_batched_and_per_chain_match_tile(pair):
    port, _ = pair
    b = _points(np.random.default_rng(3), port)
    bt = torch.as_tensor(b)
    lp_tile, g_tile = port.tile_value_and_grad(bt, *port.tile_consts)
    np.testing.assert_allclose(logdensity_batched(port, bt.T).numpy(), lp_tile[0].numpy(),
                               rtol=1e-5)
    for c in (1, 5, 30):
        lp, g = logdensity_and_gradient(port, bt[:, c])
        np.testing.assert_allclose(float(lp), float(lp_tile[0, c]), rtol=1e-5)
        np.testing.assert_allclose(float(logdensity(port, bt[:, c])), float(lp), rtol=1e-6)
        X = port.tile_consts[0].numpy()
        assert np.all(np.abs(g.numpy() - g_tile[:, c].numpy())
                      <= 1e-5 * (np.abs(X).sum(0) + 0.01 * np.abs(b[:, c])))


def test_per_chain_density_matches_jax(pair):
    port, ref = pair
    b = _points(np.random.default_rng(5), port)
    for c in (1, 9):
        lp_ref, g_ref = ref.logdensity_and_gradient_fn(jnp.asarray(b[:, c]))
        lp, g = logdensity_and_gradient(port, torch.as_tensor(b[:, c]))
        np.testing.assert_allclose(float(lp), float(lp_ref), rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-4)


def test_from_numpy_and_small_shapes():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    y = (rng.uniform(size=64) < 0.5).astype(np.float32)
    port = logistic_regression_from_numpy(X, y, prior_scale=3.0, device="cpu")
    ref = ref_targets.logistic_regression_model(X=X, y=y, prior_scale=3.0)
    b = rng.normal(size=(8, 13)).astype(np.float32)  # 64 observations, 13 chains
    lp_ref, g_ref = _vjp(ref, b)
    lp, g = port.tile_value_and_grad(torch.as_tensor(b), *port.tile_consts)
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-4, atol=1e-4)
    assert not hasattr(port, "beta_true")
    with pytest.raises(ValueError, match="y along with X"):
        logistic_regression_model(X=X, device="cpu")


def test_observation_count_not_a_multiple_of_eight():
    """The interleaved observation sum pads the last block with zeros."""
    port = logistic_regression_model(37, 4, seed=3, device="cpu")
    ref = ref_targets.logistic_regression_model(37, 4, seed=3)
    b = np.random.default_rng(1).normal(size=(4, 9)).astype(np.float32)
    lp_ref, _ = _vjp(ref, b)
    lp, _ = port.tile_value_and_grad(torch.as_tensor(b), *port.tile_consts)
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=1e-5)


def test_consts_size_error_names_the_size():
    """Constants above the 227 KB a block may use are refused before any
    launch, with the size in the message; up to it they are taken."""
    limit = _build.MAX_SHARED_BYTES // 4
    flat, n = flat_consts((torch.zeros(limit),), "cpu")
    assert n == limit and flat.shape == (limit,)
    with pytest.raises(ValueError, match=f"{(limit + 1) * 4} bytes"):
        flat_consts((torch.zeros(limit - 3), torch.zeros(4)), "cpu")
    with pytest.raises(ValueError, match="227 KB"):
        _build.check_shared_memory(limit + 1)
    _build.check_shared_memory(256 * 33 + 1)  # the d = 32 target: 33.8 KB
