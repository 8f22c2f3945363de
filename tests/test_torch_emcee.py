"""The emcee ensemble sampler in advancedmh_tpu_torch: tests/test_emcee.py's
cases on the torch engine, one plain stretch half-move against the formula
in numpy, and the fused kernel's plain version.

The model (≙ reference test/emcee.jl): s ~ InverseGamma(2, 3), m ~ N(0, √s),
observations 1.5 and 2.0 from N(m, √s); analytic posterior means s̄ = 49/24,
m̄ = 7/6.
"""
import numpy as np
import pytest
import torch

from advancedmh_tpu_torch import (
    DensityModel,
    Ensemble,
    InverseGamma,
    MvNormal,
    Normal,
    StretchProposal,
    WalkProposal,
    sample,
)
from advancedmh_tpu_torch.convert import emcee_demo_from_numpy, transition_from_numpy
from advancedmh_tpu_torch.ops import emcee_sample_reference, fused_emcee_sample
from advancedmh_tpu_torch.ops.emcee import (emcee_uniforms, half_move, red_black_step,
                                            stretch_draws)

S_TRUE = 49.0 / 24.0
M_TRUE = 7.0 / 6.0
PRIOR = [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logprob_untransformed(theta):
    s, m = theta[0], theta[1]
    safe_s = torch.clamp(s, min=1e-6)
    sq = torch.sqrt(safe_s)
    lp = (InverseGamma(2.0, 3.0).log_prob(safe_s) + Normal(0.0, sq).log_prob(m)
          + Normal(m, sq).log_prob(1.5) + Normal(m, sq).log_prob(2.0))
    return torch.where(s > 0, lp, torch.full_like(lp, -torch.inf))


def _logprob_transformed(theta):
    logs, m = theta[0], theta[1]
    s = torch.exp(logs)
    sq = torch.sqrt(s)
    return (InverseGamma(2.0, 3.0).log_prob(s) + Normal(0.0, sq).log_prob(m)
            + Normal(m, sq).log_prob(1.5) + Normal(m, sq).log_prob(2.0) + logs)


MODEL = DensityModel(_logprob_untransformed, device="cpu")
DEMO = emcee_demo_from_numpy(device="cpu")


# ---- tests/test_emcee.py on the torch engine -----------------------------------


def test_posterior_means():
    chains = sample(MODEL, Ensemble(1000, StretchProposal(PRIOR)), 1000, key=100,
                    chain_type="chains", param_names=["s", "m"])
    assert chains.n_chains == 1000  # walkers as chains (the 3-D path)
    assert chains.range == range(1, 1001)
    assert abs(float(chains["s"].mean()) - S_TRUE) < 0.1
    assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1


def test_discard_thinning():
    chains = sample(MODEL, Ensemble(1000, StretchProposal(PRIOR)), 500, key=101,
                    chain_type="chains", param_names=["s", "m"], discard_initial=25,
                    thinning=4)
    assert chains.range == range(26, 26 + 4 * 500, 4)
    assert abs(float(chains["s"].mean()) - S_TRUE) < 0.1
    assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1


def test_posterior_means_with_jacobian():
    model = DensityModel(_logprob_transformed, device="cpu")
    spl = Ensemble(1000, StretchProposal(MvNormal.standard(2, device="cpu")))
    chains = sample(model, spl, 1000, key=102, chain_type="chains", param_names=["logs", "m"])
    assert abs(float(torch.exp(chains["logs"]).mean()) - S_TRUE) < 0.1
    assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1


def test_walk_move_posterior_means():
    res = sample(MODEL, Ensemble(500, WalkProposal(PRIOR)), 1500, key=100,
                 discard_initial=1000)
    draws = res.transitions.params.reshape(-1, 2)
    assert abs(float(draws[:, 0].mean()) - S_TRUE) < 0.12
    assert abs(float(draws[:, 1].mean()) - M_TRUE) < 0.12
    assert 0.1 < float(res.transitions.accepted.float().mean()) < 0.95


def test_walk_move_couples_leaves():
    rho = 0.8

    def lp(th):
        a, b = th["a"], th["b"]
        return -0.5 * (a * a - 2 * rho * a * b + b * b) / (1 - rho * rho)

    spl = Ensemble(256, WalkProposal({"a": Normal(0.0, 1.0), "b": Normal(0.0, 1.0)}))
    res = sample(DensityModel(lp, device="cpu"), spl, 1000, key=5, discard_initial=500)
    a = res.transitions.params["a"].reshape(-1).numpy()
    b = res.transitions.params["b"].reshape(-1).numpy()
    assert abs(np.corrcoef(a, b)[0, 1] - rho) < 0.1


def test_walker_shapes_and_chains_of_ensembles():
    spl = Ensemble(8, StretchProposal(PRIOR))
    res = sample(MODEL, spl, 5, key=0)
    assert tuple(res.transitions.params.shape) == (5, 8, 2)
    assert tuple(res.transitions.lp.shape) == (5, 8)
    c = sample(MODEL, spl, 5, key=0, num_chains=3, chain_type="chains")
    assert c.values.shape == (5, 2, 24)


def test_initial_params_override_and_mismatch():
    spl = Ensemble(4, StretchProposal(PRIOR))
    init = np.tile([2.0, 1.0], (4, 1))
    res = sample(MODEL, spl, 3, key=0, initial_params=init, discard_initial=0)
    np.testing.assert_allclose(res.transitions.params[0].numpy(), init)
    with pytest.raises(ValueError, match="n_walkers"):
        sample(MODEL, Ensemble(8, StretchProposal(PRIOR)), 3, key=0,
               initial_params=np.tile([2.0, 1.0], (6, 1)))


def test_acceptance_happens():
    res = sample(MODEL, Ensemble(64, StretchProposal(PRIOR)), 100, key=1)
    assert 0.05 < float(res.transitions.accepted[1:].float().mean()) < 0.95


# ---- the plain half-move against numpy and against the JAX package -------------


def test_half_move_matches_numpy():
    """Fixed (partner, z, accept) uniforms through the kernel's plain
    half-move against the formula in float64 numpy."""
    model = emcee_demo_from_numpy(device="cpu")
    rng = np.random.default_rng(3)
    W, T = 16, 8
    H = T // 2
    x = np.stack([rng.uniform(0.5, 4.0, W), rng.normal(1.0, 1.0, W)]).astype(np.float32)
    xt = torch.tensor(x)
    lp = model.tile_density(xt)
    u = torch.as_tensor(rng.uniform(0.01, 0.99, size=(W // 2, 3)).astype(np.float32))
    walker = torch.tensor([e * T + i for e in range(W // T) for i in range(H)])  # h = 0
    other = (walker // T) * T + H
    x0, lp0 = xt.clone(), lp.clone()
    k, z, log_u = stretch_draws(u, H, 2.0)
    acc = half_move(xt, lp, walker, other + k, z, log_u, model.tile_density, ())
    un = u.numpy().astype(np.float64)
    k = np.minimum(np.floor(un[:, 0] * H), H - 1).astype(int)
    z = ((2.0 - 1.0) * un[:, 1] + 1.0) ** 2 / 2.0
    xa, xp = x[:, walker.numpy()], x[:, other.numpy() + k]
    y = xp + z * (xa - xp)
    lp_y = model.tile_density(torch.as_tensor(y.astype(np.float32)))[0].numpy()
    want_acc = np.log(un[:, 2]) <= (2 - 1) * np.log(z) + lp_y - lp0[0, walker].numpy()
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    np.testing.assert_allclose(xt[:, walker].numpy(), np.where(want_acc, y, xa), rtol=1e-6)
    assert torch.equal(xt[:, other], x0[:, other])  # the other half is frozen


def _jax_ensemble(W):
    """JAX's Ensemble on its emcee model's tile density (the fused kernels'
    form; tests/test_torch_targets_grad.py holds it against the per-point
    logprob), with W walkers (W/4 of them outside the support) and their lp."""
    import jax.numpy as jnp

    from advancedmh_tpu.models.density import DensityModel as RefModel
    from advancedmh_tpu.models.targets import emcee_demo_model as ref_demo
    from advancedmh_tpu.samplers.emcee import Ensemble as RefEnsemble
    from advancedmh_tpu.samplers.emcee import StretchProposal as RefStretch

    tile = ref_demo().tile_density
    model = RefModel(lambda th: tile(th.reshape(2, 1))[0, 0], dimension=2)
    rng = np.random.default_rng(W)
    x = np.stack([rng.uniform(-1.0, 4.0, W), rng.normal(1.0, 1.0, W)], axis=1)
    x = x.astype(np.float32)
    lp = np.asarray(tile(jnp.asarray(x.T)))[0]
    return RefEnsemble(W, RefStretch(None)), model, x, lp


def _jax_draws(key, n):
    """The numbers JAX's _half_move draws from ``key`` for n moving walkers:
    the partner's index in the other half, z's uniform, and the exponential
    of the accept test (−e takes the place of log u)."""
    import jax

    key_j, key_z, key_acc = jax.random.split(key, 3)
    return (np.array(jax.random.randint(key_j, (n,), 0, n)),
            np.array(jax.random.uniform(key_z, (n,))),
            np.array(jax.random.exponential(key_acc, (n,))))


def _port_draws(draws, H):
    """JAX's draws of one half-move as the port's (partner offset k, z,
    log u): the partner's index j maps to the uniform (j + 1/2)/H, which
    stretch_draws turns back into j."""
    j, u, e = draws
    uu = torch.as_tensor(np.stack([(j + 0.5) / H, u, np.full(H, 0.5)], axis=1)
                         .astype(np.float32))
    k, z, _ = stretch_draws(uu, H, 2.0)
    assert torch.equal(k, torch.as_tensor(j, dtype=torch.int64))
    return k, z, -torch.as_tensor(e, dtype=torch.float32)


@pytest.mark.parametrize("W", [16, 64])
def test_half_move_matches_jax(W):
    """One half-move with JAX's own random numbers against JAX's
    Ensemble._half_move on the same walkers: states and lp at 1e-5, the
    accept flags equal."""
    import jax
    import jax.numpy as jnp

    ens, model, x, lp = _jax_ensemble(W)
    H = W // 2
    key = jax.random.PRNGKey(W)
    want_x, want_lp, want_acc = ens._half_move(
        key, jnp.asarray(x[:H]), jnp.asarray(lp[:H]), jnp.asarray(x[H:]),
        jnp.asarray(lp[H:]), model)
    xt, lpt = torch.as_tensor(x.T.copy()), torch.as_tensor(lp[None].copy())
    k, z, log_u = _port_draws(_jax_draws(key, H), H)
    acc = half_move(xt, lpt, torch.arange(H), H + k, z, log_u, DEMO.tile_density, ())
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    assert 0 < int(acc.sum()) < H
    np.testing.assert_allclose(xt[:, :H].numpy().T, np.asarray(want_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lpt[0, :H].numpy(), np.asarray(want_lp), rtol=1e-5, atol=1e-5)
    assert np.array_equal(xt[:, H:].numpy().T, x[H:])  # the other half is frozen


@pytest.mark.parametrize("W", [16, 64])
def test_red_black_step_matches_jax(W):
    """Three red_black_steps (the second half moves against the updated
    first) with JAX's numbers against JAX's Ensemble.step: states and lp at
    1e-5, the accept flags equal."""
    import jax
    import jax.numpy as jnp

    from advancedmh_tpu.samplers.base import Transition as RefTransition

    ens, model, x, lp = _jax_ensemble(W)
    H = W // 2
    state = RefTransition(jnp.asarray(x), jnp.asarray(lp), jnp.zeros((W,), bool))
    xt, lpt = torch.as_tensor(x.T.copy()), torch.as_tensor(lp[None].copy())
    for key in jax.random.split(jax.random.PRNGKey(100 + W), 3):
        state, _ = ens.step(key, state, model)
        k, z, log_u = (torch.stack(v) for v in zip(
            *(_port_draws(_jax_draws(kh, H), H) for kh in jax.random.split(key))))
        acc = red_black_step(xt, lpt, torch.arange(W).view(2, H),
                             torch.tensor([[H], [0]]) + k, z, log_u, DEMO.tile_density, ())
        np.testing.assert_array_equal(acc.reshape(-1).numpy(), np.asarray(state.accepted))
        np.testing.assert_allclose(xt.numpy().T, np.asarray(state.params), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lpt[0].numpy(), np.asarray(state.lp), rtol=1e-5,
                                   atol=1e-5)


def test_uniforms_depend_only_on_step_and_walker():
    _, u1 = emcee_uniforms(7, 5, 3, 16, 8, "cpu")
    _, u2 = emcee_uniforms(7, 6, 2, 16, 8, "cpu")
    assert torch.equal(u1[1:], u2)
    assert float(u1.min()) > 0.0 and float(u1.max()) < 1.0


# ---- the fused kernel's plain version -------------------------------------------


def test_fused_plain_posterior_means():
    model = emcee_demo_from_numpy(device="cpu")
    spl = Ensemble(1024, StretchProposal(PRIOR))
    res = sample(model, spl, 1000, key=100, engine="fused", discard_initial=200)
    draws = res.transitions.params.reshape(-1, 2)
    assert abs(float(draws[:, 0].mean()) - S_TRUE) < 0.1
    assert abs(float(draws[:, 1].mean()) - M_TRUE) < 0.1
    assert 0.1 < float(res.transitions.accepted.float().mean()) < 0.9
    assert tuple(res.transitions.params.shape) == (1000, 1024, 2)
    assert tuple(res.final_state.params.shape) == (1024, 2)
    chains = res.to_chains(param_names=["s", "m"])
    assert chains.n_chains == 1024 and chains.range == range(201, 1201)


def test_fused_split_run_and_tile_walkers():
    model = emcee_demo_from_numpy(device="cpu")
    spl = Ensemble(48, StretchProposal(PRIOR))
    kw = dict(key=8, engine="fused", discard_initial=1)
    whole = sample(model, spl, 20, **kw)
    first = sample(model, spl, 10, **kw)
    second = sample(model, spl, 10, initial_state=first.final_state, iteration_offset=10, **kw)
    joined = torch.cat([first.transitions.params, second.transitions.params])
    assert torch.equal(joined, whole.transitions.params)
    # several independent ensembles (tile_walkers T = 12 < W = 48): each
    # 12-walker slice's draws equal a run of that slice alone, made with the
    # uniforms of its global walker indices
    W, T, n = 48, 12, 4
    H = T // 2
    x = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 3.0, (2, W)).astype(np.float32))
    out = fused_emcee_sample(model.tile_density, model.cuda_density, x,
                             model.tile_density(x), (), 3, stretch_length=2.0,
                             tile_walkers=T, burn=0, thin=1, n_samples=n)
    assert tuple(out[0].shape) == (n, 2, W)
    walker, u = emcee_uniforms(3, 1, n, W, T, "cpu")
    for e in range(W // T):
        cols, moving = slice(e * T, (e + 1) * T), slice(e * H, (e + 1) * H)
        xe = x[:, cols].clone()
        lpe = model.tile_density(xe)
        for t in range(n):
            k, z, log_u = stretch_draws(u[t, :, moving], H, 2.0)
            acc = red_black_step(xe, lpe, walker[:, moving] - e * T,
                                 torch.tensor([[H], [0]]) + k, z, log_u, model.tile_density, ())
            assert torch.equal(out[0][t, :, cols], xe) and torch.equal(out[1][t, :, cols], lpe)
            assert torch.equal(out[2][t, 0, cols], acc.reshape(-1).float())
    assert not torch.equal(out[0][-1], x.expand(2, W))  # the walkers moved


def test_fused_walker_counts():
    model = emcee_demo_from_numpy(device="cpu")
    res = sample(model, Ensemble(1000, StretchProposal(PRIOR)), 3, key=0, engine="fused")
    assert tuple(res.transitions.params.shape) == (3, 1000, 2)  # no multiple-of-256 rule
    with pytest.raises(ValueError, match="even"):
        sample(model, Ensemble(999, StretchProposal(PRIOR)), 3, key=0, engine="fused")


def test_fused_rejects_walk_and_needs_a_tile_density():
    with pytest.raises(NotImplementedError, match="StretchProposal"):
        sample(emcee_demo_from_numpy(device="cpu"), Ensemble(512, WalkProposal(PRIOR)), 10,
               key=0, engine="fused")
    with pytest.raises(ValueError, match="tile_density"):
        sample(MODEL, Ensemble(1024, StretchProposal(PRIOR)), 10, key=0, engine="fused")


def test_fused_plain_matches_reference_entry_point():
    """The wrapper on CPU tensors is the plain version, launching nothing."""
    model = emcee_demo_from_numpy(device="cpu")
    st = transition_from_numpy(np.tile([2.0, 1.0], (32, 1)) + np.arange(32)[:, None] / 32,
                               np.zeros(32), np.zeros(32), device="cpu")
    x = st.params.T.contiguous()
    kw = dict(stretch_length=2.0, tile_walkers=16, burn=2, thin=2, n_samples=3)
    fused_emcee_sample.launches = 0
    got = fused_emcee_sample(model.tile_density, model.cuda_density, x,
                             model.tile_density(x), (), 11, **kw)
    want = emcee_sample_reference(model.tile_density, None, x, model.tile_density(x),
                                  (), 11, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_emcee_sample.launches == 0
