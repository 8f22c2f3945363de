"""Proposal algebra and the MH step of advancedmh_tpu_torch against advancedmh_tpu.

Deterministic parts (Hastings terms, the noise-fed step) match at float32
tolerance; sampling runs match in distribution, at the tolerances of
tests/test_pallas.py (means within 0.05, acceptance within 0.1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
import advancedmh_tpu_torch as port
from advancedmh_tpu.models.targets import gaussian_mean_scale_model as ref_model
from advancedmh_tpu_torch.convert import (
    gaussian_mean_scale_from_numpy,
    mvnormal_from_numpy,
)
from advancedmh_tpu_torch.ops.rwmh import rwmh_step, scale_block

DATA = np.random.default_rng(1234).normal(size=30)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_symmetric_flag_gives_build_time_zero():
    spl = port.RWMH(port.MvNormal(torch.zeros(2), scale=0.3))
    assert spl.proposal.symmetric is True
    x = torch.randn(8, 2)
    term = port.logratio_proposal_density(spl.proposal, x, x + 1.0, batch_ndim=1)
    assert isinstance(term, float) and term == 0.0
    tree = {"a": port.SymmetricRandomWalkProposal(port.Normal(0.0, 1.0)),
            "b": port.SymmetricStaticProposal(port.Normal(0.0, 2.0))}
    pt = {"a": torch.zeros(3), "b": torch.ones(3)}
    term = port.logratio_proposal_density(tree, pt, pt, batch_ndim=1)
    assert isinstance(term, float) and term == 0.0


def test_nonzero_mean_increment_is_not_flagged_symmetric():
    spl = port.RWMH(port.MvNormal(torch.tensor([0.1, 0.0])))
    assert spl.proposal.symmetric is False
    assert port.RWMH(2, device="cpu").proposal.symmetric is True


@pytest.mark.parametrize("kind", ["static", "random_walk"])
def test_logratio_asymmetric_against_jax(kind):
    rng = np.random.default_rng(5)
    loc = rng.normal(size=2)
    diag = rng.uniform(0.3, 1.5, size=2)
    state, cand = rng.normal(size=(16, 2)), rng.normal(size=(16, 2))
    p_dist = mvnormal_from_numpy(loc, scale_diag=diag, device="cpu")
    r_dist = ref.MvNormal(jnp.asarray(loc, jnp.float32), scale_diag=jnp.asarray(diag, jnp.float32))
    P = port.StaticProposal if kind == "static" else port.RandomWalkProposal
    R = ref.StaticProposal if kind == "static" else ref.RandomWalkProposal
    got = port.logratio_proposal_density(P(p_dist), _t(state), _t(cand), batch_ndim=1)
    want = ref.logratio_proposal_density(
        R(r_dist), jnp.asarray(state, jnp.float32), jnp.asarray(cand, jnp.float32), batch_ndim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_q_tree_against_jax():
    rng = np.random.default_rng(6)
    t, tc = rng.normal(size=(2, 4)), rng.normal(size=(2, 4))
    p_tree = (port.StaticProposal(port.Normal(0.5, 2.0)),
              port.RandomWalkProposal(port.Normal(0.0, 0.5)))
    r_tree = (ref.StaticProposal(ref.Normal(0.5, 2.0)),
              ref.RandomWalkProposal(ref.Normal(0.0, 0.5)))
    got = port.q(p_tree, (_t(t[0]), _t(t[1])), (_t(tc[0]), _t(tc[1])), batch_ndim=1)
    want = ref.q(r_tree, (jnp.asarray(t[0], jnp.float32), jnp.asarray(t[1], jnp.float32)),
                 (jnp.asarray(tc[0], jnp.float32), jnp.asarray(tc[1], jnp.float32)),
                 batch_ndim=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_propose_follows_the_tree_shape():
    gen = torch.Generator().manual_seed(0)
    tree = {"a": port.RandomWalkProposal(port.Normal(0.0, 1.0)),
            "b": [port.StaticProposal(port.MvNormal(torch.zeros(3)))]}
    params = {"a": torch.zeros(5), "b": [torch.zeros(5, 3)]}
    out = port.propose(gen, tree, params, (5,))
    assert set(out) == {"a", "b"} and tuple(out["b"][0].shape) == (5, 3)
    init = port.propose_initial(gen, tree, (5,))
    assert tuple(init["a"].shape) == (5,)


@pytest.mark.parametrize("tril", [False, True])
def test_noise_fed_step_matches_jax_decisions(tril):
    """Same start, same z and u: the plain RWMH step and the same step built
    from JAX's tile density and jnp.where make identical decisions."""
    rng = np.random.default_rng(11 + tril)
    C, n_steps = 1024, 8
    scale = np.array([[0.35, 0.0], [0.1, 0.3]]) if tril else np.array([0.35, 0.35])
    x0 = np.stack([rng.normal(size=C), rng.uniform(-0.5, 2.0, size=C)]).astype(np.float32)
    z = rng.normal(size=(n_steps, 2, C)).astype(np.float32)
    u = rng.uniform(size=(n_steps, C)).astype(np.float32)

    pm = gaussian_mean_scale_from_numpy(DATA, device="cpu")
    rm = ref_model(data=DATA)
    obs = jnp.asarray(rm.tile_consts[0])
    s_arr, is_tril = scale_block(scale, 2, "cpu")
    xp, lpp = _t(x0), pm.tile_density(_t(x0), *pm.tile_consts)
    xj, lpj = jnp.asarray(x0), rm.tile_density(jnp.asarray(x0), obs)
    sj = jnp.asarray(scale, jnp.float32)
    for t in range(n_steps):
        xp, lpp, acc_p = rwmh_step(xp, lpp, _t(z[t]), torch.log(_t(u[t])), s_arr,
                                   is_tril, pm.tile_density, pm.tile_consts)
        zt = jnp.asarray(z[t])
        # pallas_mh.py::_perturb_fn: column accumulation, or per-dim multiply
        cand = xj + (sj[:, 0:1] * zt[0:1] + sj[:, 1:2] * zt[1:2] if tril
                     else sj[:, None] * zt)
        lpc = rm.tile_density(cand, obs)
        acc_j = jnp.log(jnp.asarray(u[t]))[None] < lpc - lpj
        xj, lpj = jnp.where(acc_j, cand, xj), jnp.where(acc_j, lpc, lpj)
        np.testing.assert_array_equal(acc_p.numpy(), np.asarray(acc_j))
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-6)


def test_torch_engine_posterior_matches_jax_xla():
    pm = gaussian_mean_scale_from_numpy(DATA, device="cpu")
    rm = ref_model(data=DATA)
    kw = dict(num_chains=512, discard_initial=1000, initial_params=[0.0, 1.0])
    res_p = port.sample(pm, port.RWMH(port.MvNormal(torch.zeros(2), scale=0.3)),
                        1000, key=7, **kw)
    res_j = ref.sample(rm, ref.RWMH(ref.MvNormal(jnp.zeros(2), scale=0.3)), 1000,
                       key=7, **{**kw, "initial_params": jnp.asarray([0.0, 1.0])})
    dp = res_p.transitions.params.reshape(-1, 2).numpy()
    dj = np.asarray(res_j.transitions.params).reshape(-1, 2)
    np.testing.assert_allclose(dp.mean(0), dj.mean(0), atol=0.05)
    acc_p = res_p.transitions.accepted.float().mean().item()
    acc_j = float(np.asarray(res_j.transitions.accepted).mean())
    assert abs(acc_p - acc_j) < 0.1


def test_step_single_chain_and_setparams():
    pm = gaussian_mean_scale_from_numpy(DATA, device="cpu")
    spl = port.RWMH(port.MvNormal(torch.zeros(2), scale=0.3))
    gen = torch.Generator().manual_seed(1)
    t0, s = spl.init(gen, pm, torch.tensor([0.0, 1.0]))
    t1, s = spl.step(gen, s, pm)
    assert tuple(t1.params.shape) == (2,) and t1.accepted.shape == ()
    moved = port.setparams(pm, t1, torch.tensor([0.1, 1.1]))
    np.testing.assert_allclose(
        float(moved.lp), float(pm.logdensity_fn(torch.tensor([0.1, 1.1]))))
    assert torch.equal(port.getparams(moved), torch.tensor([0.1, 1.1]))


def test_tree_walks_hold_no_reference_cycle():
    """Flattening, rebuilding and matching a tree keep nothing alive once
    their results are dropped, without the cyclic garbage collector (a
    self-calling nested walk would keep the leaves it collected, e.g. a
    fused run's draws, until a collection)."""
    import gc
    import weakref

    from advancedmh_tpu_torch.utils.tree import flatten_up_to, tree_flatten

    t = torch.zeros(4)
    alive = weakref.ref(t)
    gc.disable()
    try:
        leaves, unflatten = tree_flatten({"a": t, "b": [t, (t,)]})
        assert unflatten([1, 2, 3]) == {"a": 1, "b": [2, (3,)]}
        assert len(flatten_up_to({"a": 0, "b": 0}, {"a": t, "b": [t]})) == 2
        del leaves, unflatten, t
        assert alive() is None
    finally:
        gc.enable()
