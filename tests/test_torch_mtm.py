"""Multiple-Try Metropolis in advancedmh_tpu_torch against advancedmh_tpu.

- the kernels' streaming, clamped log α against ``jax.scipy.special.logsumexp``
  on the same lp arrays (1e-6), and the all-clamped step pinned: the
  kernels' arithmetic accepts it, the torch engine (XLA's form) rejects it;
- the plain step against the torch engine's step on the same noise
  (decisions equal, states at 1e-6), and k = 1 against the MH step bit for
  bit;
- tests/test_mtm.py's assertions on the torch engine, at their tolerances
  (fewer steps), and the moments of the JAX XLA engine's run within 4
  combined MCSE;
- the fused engine on its plain version: the MTM branch, moments against
  the torch engine, a split run bit for bit, the wrapper's plain dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp as jax_logsumexp

import advancedmh_tpu as ref
from advancedmh_tpu.models.targets import gaussian_mean_scale_model as jax_flagship
from advancedmh_tpu_torch import (DensityModel, MetropolisHastings, MultipleTryMetropolis,
                                  MvNormal, Normal, RandomWalkProposal,
                                  SymmetricRandomWalkProposal, ess_bulk, sample)
from advancedmh_tpu_torch.convert import transition_from_numpy
from advancedmh_tpu_torch.models import gaussian_mean_scale_model
from advancedmh_tpu_torch.ops import (fused_mtm, fused_mtm_sample, mtm_reference, mtm_step,
                                      streaming_logsumexp)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _proposal(scale, d=2):
    return RandomWalkProposal(MvNormal(torch.zeros(d), scale=scale))


def _mtm(scale, k):
    return MultipleTryMetropolis(_proposal(scale), k=k)


MODEL = gaussian_mean_scale_model(n_obs=300, device="cpu")  # tests/test_mtm.py's 300 obs
START = torch.tensor([0.0, 1.0])


def _mcse_close(a, b, names=(0, 1)):
    """Means of draws (chains, draws, d) within 4 combined MCSE."""
    for j in names:
        se = [float(torch.var(x[..., j])) / float(ess_bulk(x[..., j].T)) for x in (a, b)]
        assert abs(float(a[..., j].mean() - b[..., j].mean())) < 4.0 * (se[0] + se[1]) ** 0.5


# ---- the kernels' log α and the all-clamped step ---------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_streaming_log_alpha_matches_jax_logsumexp(k):
    rng = np.random.default_rng(k)
    C = 64
    cand = (rng.normal(-20.0, 30.0, (k, C))).astype(np.float32)
    refs = (rng.normal(-20.0, 30.0, (k - 1, C))).astype(np.float32)
    lp = rng.normal(-20.0, 30.0, C).astype(np.float32)
    if k > 1:  # single −inf terms beside finite ones: 0 in either form
        cand[0, ::7] = -np.inf
        lp[::5] = -np.inf
    got = (streaming_logsumexp(list(torch.as_tensor(cand)))
           - streaming_logsumexp([torch.as_tensor(lp)] + list(torch.as_tensor(refs))))
    want = (jax_logsumexp(jnp.asarray(cand), axis=0)
            - jax_logsumexp(jnp.concatenate([jnp.asarray(refs), jnp.asarray(lp)[None]]), axis=0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 4])
def test_all_clamped_step(k):
    """A state, candidates and references all outside the support (σ < 0):
    the kernels' clamped arithmetic gives log α = 0 and accepts (lp becomes
    −1e30); the torch engine's unclamped logsumexp gives NaN and rejects
    (k = 1 there is the MH step: −inf − (−inf) = NaN)."""
    C = 16
    model = gaussian_mean_scale_model(device="cpu")
    x = torch.tensor([[0.0] * C, [-3.0] * C])
    lp = model.tile_density(x, *model.tile_consts)
    assert bool(torch.isinf(lp).all())
    g = torch.Generator().manual_seed(0)
    z_cand, z_ref = torch.randn(k, 2, C, generator=g), torch.randn(k - 1, 2, C, generator=g)
    u = torch.rand(k, C, generator=g)
    xn, lpn, acc = mtm_step(x, lp, z_cand, u, z_ref, torch.log(torch.rand(C, generator=g)),
                            torch.full((2,), 1e-3), False, model.tile_density, model.tile_consts)
    assert bool(acc.all()) and bool((lpn == -1e30).all()) and not torch.equal(xn, x)
    state = transition_from_numpy(x.T.numpy(), lp[0].numpy(), np.zeros(C, bool), device="cpu")
    spl = MultipleTryMetropolis(_proposal(1e-3), k=k)
    st = spl.step_batched(torch.Generator().manual_seed(1), state, model, (C,))[1]
    assert not bool(st.accepted.any()) and bool(torch.isinf(st.lp).all())


# ---- the plain step against the torch engine ----------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_plain_step_matches_torch_engine_on_the_same_noise(k):
    """The torch engine's step_batched draws its candidates' normals, the
    Gumbel uniforms, the references' normals and the Exp(1) of its accept
    test from one generator; the same numbers, replayed from a copy of it,
    drive the plain (kernel) step."""
    C, scale = 96, 0.3
    model = gaussian_mean_scale_model(device="cpu")
    rng = np.random.default_rng(k)
    x0 = np.stack([rng.normal(0.0, 0.3, C), rng.uniform(0.5, 1.5, C)], 1).astype(np.float32)
    state = transition_from_numpy(x0, model.logdensity_batched_fn(torch.as_tensor(x0)).numpy(),
                                  np.zeros(C, bool), device="cpu")
    xt, lpt = state.params.T.contiguous(), model.tile_density(state.params.T, *model.tile_consts)
    spl = _mtm(scale, k)
    for t in range(12):
        gen = torch.Generator().manual_seed(100 + t)
        replay = torch.Generator()
        replay.set_state(gen.get_state())
        state = spl.step_batched(gen, state, model, (C,))[1]
        eps_c = torch.randn((k, C, 2), generator=replay)
        u = torch.rand((k, C), generator=replay) if k > 1 else torch.full((1, C), 0.5)
        eps_r = torch.randn((k - 1, C, 2), generator=replay)
        e = torch.empty((C,)).exponential_(generator=replay)
        xt, lpt, acc = mtm_step(xt, lpt, eps_c.permute(0, 2, 1), u, eps_r.permute(0, 2, 1), -e,
                                torch.full((2,), scale), False, model.tile_density,
                                model.tile_consts)
        np.testing.assert_array_equal(acc[0].numpy(), state.accepted.numpy())
        np.testing.assert_allclose(xt.T.numpy(), state.params.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(lpt[0].numpy(), state.lp.numpy(), rtol=1e-6, atol=1e-6)
    assert 0 < int(acc.sum()) < C


def test_k1_is_the_mh_step_bit_for_bit():
    model = gaussian_mean_scale_model(device="cpu")
    prop = _proposal(0.2)
    st_mh = st_mtm = sample(model, MetropolisHastings(prop), 1, num_chains=64, key=0,
                            initial_params=START, discard_initial=1).final_state
    for t in range(20):
        st_mh = MetropolisHastings(prop).step_batched(torch.Generator().manual_seed(t), st_mh,
                                                      model, (64,))[1]
        st_mtm = MultipleTryMetropolis(prop, k=1).step_batched(torch.Generator().manual_seed(t),
                                                               st_mtm, model, (64,))[1]
        for f in ("params", "lp", "accepted"):
            assert torch.equal(getattr(st_mh, f), getattr(st_mtm, f))


# ---- tests/test_mtm.py on the torch engine ---------------------------------------------


class TestMTMTorchEngine:
    def test_posterior_moments(self):
        res = sample(MODEL, _mtm(0.3, 4), 1500, key=0, num_chains=32, initial_params=START,
                     discard_initial=500)
        x = res.transitions.params.reshape(-1, 2).numpy()
        assert abs(x[:, 0].mean()) < 0.1
        assert abs(x[:, 1].mean() - 1.0) < 0.1

    def test_k1_is_plain_mh(self):
        res = sample(MODEL, _mtm(0.1, 1), 2000, key=1, num_chains=32, initial_params=START,
                     discard_initial=500)
        x = res.transitions.params.reshape(-1, 2).numpy()
        assert abs(x[:, 0].mean()) < 0.1
        assert abs(x[:, 1].mean() - 1.0) < 0.1

    def test_acceptance_increases_with_k(self):
        accs = {}
        for k in (1, 8):
            res = sample(MODEL, _mtm(0.2, k), 600, key=2, num_chains=64, initial_params=START,
                         discard_initial=200)
            accs[k] = float(res.transitions.accepted.float().mean())
        assert accs[8] > accs[1] + 0.1, accs

    def test_single_chain_unbatched_path(self):
        res = sample(MODEL, _mtm(0.3, 3), 200, key=3, initial_params=START)
        lp = res.transitions.lp.numpy()
        assert lp.shape == (200,) and np.isfinite(lp).all()

    def test_pytree_proposal(self):
        model = DensityModel(lambda t: Normal(0.0, 1.0).log_prob(t["a"])
                             + Normal(1.0, 2.0).log_prob(t["b"]), device="cpu")
        spl = MultipleTryMetropolis({"a": RandomWalkProposal(Normal(0.0, 0.5)),
                                     "b": RandomWalkProposal(Normal(0.0, 0.5))}, k=4)
        res = sample(model, spl, 1500, key=4, num_chains=32, discard_initial=500,
                     initial_params={"a": torch.tensor(0.0), "b": torch.tensor(1.0)})
        assert abs(float(res.transitions.params["a"].mean())) < 0.15
        assert abs(float(res.transitions.params["b"].mean()) - 1.0) < 0.3

    def test_asymmetric_proposal_rejected(self):
        with pytest.raises(ValueError, match="symmetric"):
            MultipleTryMetropolis(RandomWalkProposal(MvNormal(torch.ones(2), scale=0.3)), k=4)

    def test_symmetric_assertion_accepted(self):
        MultipleTryMetropolis(SymmetricRandomWalkProposal(MvNormal(torch.ones(2), scale=0.3)),
                              k=4)

    def test_k_validation(self):
        with pytest.raises(ValueError, match="k must be"):
            _mtm(0.3, 0)

    def test_deterministic(self):
        kw = dict(key=5, num_chains=4, initial_params=START, discard_initial=1)
        r1 = sample(MODEL, _mtm(0.3, 4), 50, **kw)
        r2 = sample(MODEL, _mtm(0.3, 4), 50, **kw)
        assert torch.equal(r1.transitions.params, r2.transitions.params)


def test_moments_match_the_jax_xla_engine():
    jspl = ref.MultipleTryMetropolis(
        ref.RandomWalkProposal(ref.MvNormal(jnp.zeros(2), scale=0.2)), k=4)
    jres = ref.sample(jax_flagship(), jspl, 600, key=jax.random.key(7), num_chains=256,
                      initial_params=jnp.asarray([0.0, 1.0]), discard_initial=200)
    res = sample(gaussian_mean_scale_model(device="cpu"), _mtm(0.2, 4), 600, key=7,
                 num_chains=256, initial_params=START, discard_initial=200)
    _mcse_close(res.transitions.params, torch.as_tensor(np.asarray(jres.transitions.params)))
    acc_j = float(np.asarray(jres.transitions.accepted).mean())
    assert abs(float(res.transitions.accepted.float().mean()) - acc_j) < 0.02


# ---- the fused engine on its plain version -------------------------------------------


def test_fused_mtm_moments_match_torch_engine_and_branch_before_rwmh():
    model = gaussian_mean_scale_model(device="cpu")
    kw = dict(num_chains=256, initial_params=START, discard_initial=200)
    fused = sample(model, _mtm(0.2, 4), 500, key=11, engine="fused", **kw)
    torch_ = sample(model, _mtm(0.2, 4), 500, key=12, **kw)
    _mcse_close(fused.transitions.params, torch_.transitions.params)
    acc = float(fused.transitions.accepted.float().mean())
    # JAX measured 0.753 fused, 0.755 XLA; RWMH at this scale accepts far less
    assert 0.70 < acc < 0.80
    rw = sample(model, MetropolisHastings(_proposal(0.2)), 100, key=11, engine="fused", **kw)
    assert float(rw.transitions.accepted.float().mean()) < acc - 0.2


@pytest.mark.parametrize("scale", [0.2, [[0.2, 0.0], [0.05, 0.15]]])
def test_fused_mtm_split_run_is_bit_exact(scale):
    model = gaussian_mean_scale_model(device="cpu")
    payload = (MvNormal(torch.zeros(2), scale_tril=torch.tensor(scale)) if isinstance(scale, list)
               else MvNormal(torch.zeros(2), scale=scale))
    spl = MultipleTryMetropolis(RandomWalkProposal(payload), k=3)
    kw = dict(key=3, num_chains=100, engine="fused", thinning=3, initial_params=START)
    whole = sample(model, spl, 20, discard_initial=6, **kw)
    first = sample(model, spl, 8, discard_initial=6, **kw)
    rest = sample(model, spl, 12, discard_initial=3, initial_state=first.final_state,
                  iteration_offset=3 + 24, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))


def test_fused_wrappers_on_cpu_are_the_plain_versions():
    model = gaussian_mean_scale_model(device="cpu")
    x = START[:, None].expand(2, 32).contiguous()
    args = (model.tile_density, model.cuda_density, x, model.tile_density(x, *model.tile_consts),
            0.2, model.tile_consts, 9)
    fused_mtm.launches = fused_mtm_sample.launches = 0
    p, l, a = fused_mtm(*args, k=4, n_steps=30)
    p_r, l_r, a_r = mtm_reference(*args, k=4, n_steps=30)
    assert torch.equal(p, p_r) and torch.equal(l, l_r) and torch.equal(a, a_r)
    s = fused_mtm_sample(*args, k=4, burn=0, thin=1, n_samples=30)
    assert torch.equal(s[0][-1], p) and torch.equal(s[1][-1], l)
    assert int(s[2].sum()) == int(a.sum())
    assert fused_mtm.launches == fused_mtm_sample.launches == 0
    with pytest.raises(ValueError, match="k must be"):
        fused_mtm(*args, k=0, n_steps=3)
