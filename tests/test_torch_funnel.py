"""Neal's funnel in advancedmh_tpu_torch against advancedmh_tpu: the
per-chain log density and ``ldg``, and the tile value and gradient against
``jax.vjp`` of the JAX model's tile density (rtol 1e-6, atol 1e-5),
including the overflow region (v < −88: exp(−v) is inf, and inf·0 is NaN
where Σx² or x is 0), and the funnel on the fused engine's plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advancedmh_tpu.models.targets import neal_funnel_model as jax_funnel
from advancedmh_tpu_torch import ChEESHMC, MEADS, sample
from advancedmh_tpu_torch.models import neal_funnel_model, neal_funnel_tile


def _points(rng, d, C):
    t = rng.normal(size=(d, C)).astype(np.float32)
    t[0] = rng.uniform(-95.0, 8.0, size=C)  # v: the neck, the mouth and past exp's range
    t[0, :4] = (-89.0, -90.0, -100.0, 88.5)
    t[1:, 0] = 0.0  # Σx² = 0 where e^{-v} = inf: lp and ∂v NaN, as in JAX
    t[1, 1] = 0.0  # one x_i = 0 there: its gradient NaN, as in JAX
    return t


@pytest.mark.parametrize("d", [2, 10])
def test_tile_value_and_grad_matches_jax_vjp(d):
    rng = np.random.default_rng(d)
    t = _points(rng, d, 64)
    jm = jax_funnel(d)
    lp_j, pullback = jax.vjp(jm.tile_density, jnp.asarray(t))
    (g_j,) = pullback(jnp.ones_like(lp_j))
    pm = neal_funnel_model(d, device="cpu")
    lp, g = pm.tile_value_and_grad(torch.as_tensor(t))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-5)
    assert np.isnan(np.asarray(lp_j)[0, 0]) and np.isnan(lp.numpy()[0, 0])
    np.testing.assert_array_equal(neal_funnel_tile(torch.as_tensor(t)).numpy(), lp.numpy())


def test_logdensity_and_ldg_match_jax():
    rng = np.random.default_rng(1)
    jm, pm = jax_funnel(10), neal_funnel_model(10, device="cpu")
    for _ in range(8):
        x = rng.normal(size=10).astype(np.float32) * 2.0
        np.testing.assert_allclose(float(pm.logdensity_fn(torch.as_tensor(x))),
                                   float(jm.logdensity_fn(jnp.asarray(x))), rtol=1e-6, atol=1e-5)
        lp, g = pm.logdensity_and_gradient_fn(torch.as_tensor(x))
        lp_j, g_j = jm.logdensity_and_gradient_fn(jnp.asarray(x))
        np.testing.assert_allclose(float(lp), float(lp_j), rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-5)
    assert pm.dimension == 10 and pm.cuda_density == "neal_funnel" and pm.tile_consts == ()


def test_funnel_on_the_fused_plain_versions():
    """tests/test_pallas.py's funnel check (finite lp, the neck reached, |v̄|
    small) on the fused ChEES engine's plain versions, and MEADS(n_folds=2)
    keeps lp finite."""
    m = neal_funnel_model(10, device="cpu")
    spl = ChEESHMC(initial_step_size=0.2, initial_trajectory_length=1.0, max_leapfrog=16)
    res = sample(m, spl, 400, key=2, num_chains=1024, engine="fused", num_warmup=300,
                 discard_initial=300, initial_params=torch.zeros(10))
    v = res.transitions.params[:, :, 0].numpy()
    assert bool(torch.isfinite(res.transitions.lp).all())
    st = res.final_state
    assert bool(torch.isfinite(st.log_eps_bar).all() and torch.isfinite(st.log_traj_bar).all())
    assert (v < -2).mean() > 0.08
    assert abs(v.mean()) < 1.2
    res = sample(m, MEADS(n_folds=2), 200, key=3, num_chains=512, engine="fused",
                 discard_initial=100, initial_params=torch.zeros(10))
    assert bool(torch.isfinite(res.transitions.lp).all())
