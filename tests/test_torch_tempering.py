"""Replica exchange in advancedmh_tpu_torch against advancedmh_tpu.

- ``swap_rates`` and ``tune_betas`` against JAX's (float64, 1e-12);
- tests/test_tempering.py's assertions on the torch engine, at their
  tolerances (fewer steps; its MCMCDistributed case raises in the port),
  and the cold chain's moments within 4 combined MCSE of the JAX XLA
  engine's;
- the plain (kernel) step against the torch engine's step on the same
  noise: decisions equal, ladders at 1e-6;
- a start outside the support gives no NaN (the kernels swap by select);
- the fused engine on its plain version: the bimodal check target, a split
  run bit for bit with the swap counts carried, and a JAX state carried
  across by ``replica_exchange_state_from_numpy``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.samplers.tempering import ReplicaExchangeState as JaxState
from advancedmh_tpu.samplers.tempering import swap_rates as jax_swap_rates
from advancedmh_tpu.samplers.tempering import tune_betas as jax_tune_betas
from advancedmh_tpu_torch import (MALA, RWMH, DensityModel, MCMCDistributed, MvNormal, Normal,
                                  ReplicaExchange, ReplicaExchangeState, ess_bulk, sample,
                                  swap_rates, tune_betas)
from advancedmh_tpu_torch.convert import (replica_exchange_state_from_numpy,
                                          transition_from_numpy)
from advancedmh_tpu_torch.models import (bimodal_mixture_model, correlated_gaussian_model,
                                         gaussian_mean_scale_model)
from advancedmh_tpu_torch.ops import (fused_tempering_sample, ladder_constants,
                                      tempering_sample_reference, tempering_step)

BETAS = (1.0, 0.55, 0.3, 0.15, 0.05)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bimodal(x):
    """Equal mixture of N(−5, 1) and N(+5, 1) (tests/test_tempering.py)."""
    x = torch.reshape(x, ())
    return torch.logaddexp(Normal(-5.0, 1.0).log_prob(x), Normal(5.0, 1.0).log_prob(x)) - \
        np.log(2.0)


MODEL = DensityModel(_bimodal, dimension=1, device="cpu")
M5 = torch.tensor(-5.0)


# ---- swap_rates and tune_betas -------------------------------------------------------


def test_swap_rates_and_tune_betas_match_jax():
    rng = np.random.default_rng(0)
    acc = rng.integers(0, 50, (6, 4)).astype(np.float32)
    prop = np.concatenate([np.full((6, 3), 50.0), np.zeros((6, 1))], 1).astype(np.float32)
    st = ReplicaExchangeState(None, torch.as_tensor(acc), torch.as_tensor(prop))
    jst = JaxState(None, jnp.asarray(acc), jnp.asarray(prop))
    np.testing.assert_allclose(swap_rates(st).numpy(), np.asarray(jax_swap_rates(jst)),
                               rtol=1e-12, atol=1e-12)
    for betas, rates, target, step in [((1.0, 0.5, 0.25), [0.9, 0.05], 0.3, 1.0),
                                       (BETAS, [0.1, 0.4, 0.25, 0.6], 0.25, 0.5),
                                       ((1.0, 0.4, 0.1), [0.3, 0.3], 0.3, 1.0)]:
        np.testing.assert_allclose(tune_betas(betas, torch.tensor(rates, dtype=torch.float64),
                                              target, step),
                                   jax_tune_betas(betas, np.asarray(rates), target, step),
                                   rtol=1e-12, atol=1e-12)


# ---- tests/test_tempering.py on the torch engine -------------------------------------


class TestReplicaExchangeTorchEngine:
    def test_bimodal_mode_hopping(self):
        inner = RWMH(Normal(0.0, 0.5))
        # JAX's 4500 steps, 1500 of them discarded: every chain starts at −5
        res = sample(MODEL, ReplicaExchange(inner, betas=BETAS), 3000, key=0, num_chains=16,
                     discard_initial=1500, initial_params=M5)
        draws = res.transitions.params.numpy()  # (chains, samples)
        frac_right = (draws > 0).mean(axis=1)
        assert 0.3 < float(frac_right.mean()) < 0.7
        assert (frac_right > 0.02).all()  # every chain crossed the barrier
        assert abs(float(draws.mean())) < 1.0
        plain = sample(MODEL, inner, 2000, key=0, num_chains=16, discard_initial=500,
                       initial_params=M5)
        pd = plain.transitions.params.numpy().ravel()
        assert (pd > 0).mean() < 0.02  # stuck in the starting mode
        assert pd.mean() < -3.0

    def test_swap_rates_observed(self):
        res = sample(MODEL, ReplicaExchange(RWMH(Normal(0.0, 1.0)), betas=BETAS), 1000, key=1,
                     num_chains=8, initial_params=M5)
        rates = swap_rates(res.final_state).numpy()
        assert rates.shape == (8, len(BETAS) - 1)
        assert (rates > 0.02).all() and (rates < 0.98).all()

    def test_cold_chain_lp_is_untempered(self):
        res = sample(MODEL, ReplicaExchange(RWMH(Normal(0.0, 1.0)), betas=(1.0, 0.5)), 50,
                     key=2, num_chains=4, initial_params=M5)
        want = torch.vmap(_bimodal)(res.transitions.params.reshape(-1)).reshape(4, 50)
        np.testing.assert_allclose(res.transitions.lp.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_mala_inner_gradient_retempered(self):
        cov = torch.tensor([[1.0, 0.5], [0.5, 1.0]])
        m = DensityModel(MvNormal.from_cov(torch.zeros(2), cov).log_prob, dimension=2,
                         device="cpu")
        res = sample(m, ReplicaExchange(MALA.langevin(0.4), betas=(1.0, 0.5)), 2000, key=3,
                     num_chains=32, discard_initial=500, initial_params=torch.zeros(2))
        draws = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.07)
        np.testing.assert_allclose(np.cov(draws.T), cov.numpy(), atol=0.12)

    def test_distributed_chains_are_not_ported(self):
        pt = ReplicaExchange(RWMH(Normal(0.0, 0.5)), betas=BETAS)
        with pytest.raises(NotImplementedError, match="MCMCDistributed"):
            sample(MODEL, pt, 50, key=4, num_chains=8, chain_method=MCMCDistributed(),
                   initial_params=M5)

    def test_validation(self):
        inner = RWMH(Normal(0.0, 1.0))
        with pytest.raises(ValueError, match="cold"):
            ReplicaExchange(inner, betas=(0.9, 0.5))
        with pytest.raises(ValueError, match="descending"):
            ReplicaExchange(inner, betas=(1.0, 0.5, 0.5))
        with pytest.raises(ValueError, match="at least 2"):
            ReplicaExchange(inner, betas=(1.0,))
        with pytest.raises(ValueError, match="replica_scales"):
            ReplicaExchange(inner, betas=BETAS, replica_scales=(1.0, 2.0))
        with pytest.raises(ValueError, match="positive"):
            ReplicaExchange(inner, betas=(1.0, 0.5), replica_scales=(1.0, -1.0))
        with pytest.raises(ValueError, match="random-walk"):
            ReplicaExchange(MALA.langevin(0.1), betas=(1.0, 0.5), replica_scales=(1.0, 2.0))

    def test_replica_scales_mode_hopping(self):
        pt = ReplicaExchange(RWMH(Normal(0.0, 0.5)), betas=BETAS,
                             replica_scales=ReplicaExchange.geometric_scales(BETAS))
        res = sample(MODEL, pt, 2500, key=7, num_chains=16, discard_initial=500,
                     initial_params=M5)
        draws = res.transitions.params.numpy()
        frac_right = (draws > 0).mean(axis=1)
        assert 0.3 < float(frac_right.mean()) < 0.7
        assert abs(float(draws.mean())) < 1.0
        want = torch.vmap(_bimodal)(res.transitions.params.reshape(-1)).reshape(draws.shape)
        np.testing.assert_allclose(res.transitions.lp.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_single_chain_and_sequential(self):
        pt = ReplicaExchange(RWMH(Normal(0.0, 1.0)), betas=(1.0, 0.5, 0.25))
        res = sample(MODEL, pt, 20, key=5, initial_params=M5)
        assert tuple(res.transitions.params.shape) == (20,)
        assert tuple(res.final_state.inner.params.shape) == (3,)
        seq = sample(MODEL, pt, 20, key=5, num_chains=3, chain_method="sequential",
                     initial_params=M5, collect_states=True)
        assert tuple(seq.final_state.swap_accept_count.shape) == (3, 2)
        assert seq.states.raw_lp is None


def test_cold_chain_moments_match_the_jax_xla_engine():
    cov = np.array([[1.5, 0.6], [0.6, 1.0]])
    jm = ref.DensityModel(ref.MvNormal.from_cov(jnp.zeros(2), jnp.asarray(cov, jnp.float32))
                          .log_prob, dimension=2)
    jpt = ref.ReplicaExchange(ref.RWMH(ref.MvNormal(jnp.zeros(2), scale=0.8)), betas=(1.0, 0.4))
    jres = ref.sample(jm, jpt, 500, key=jax.random.key(3), num_chains=256,
                      initial_params=jnp.zeros(2), discard_initial=200)
    pt = ReplicaExchange(RWMH(MvNormal(torch.zeros(2), scale=0.8)), betas=(1.0, 0.4))
    res = sample(correlated_gaussian_model(cov, device="cpu"), pt, 500, key=3, num_chains=256,
                 initial_params=torch.zeros(2), discard_initial=200)
    a, b = res.transitions.params, torch.as_tensor(np.array(jres.transitions.params))
    for f in (lambda x: x[..., 0], lambda x: x[..., 1], lambda x: x[..., 0] * x[..., 1]):
        fa, fb = f(a), f(b)
        se = [float(torch.var(v)) / float(ess_bulk(v.T)) for v in (fa, fb)]
        assert abs(float(fa.mean() - fb.mean())) < 4.0 * (se[0] + se[1]) ** 0.5
    rates_j = np.asarray(jax_swap_rates(jres.final_state)).mean()
    assert abs(float(swap_rates(res.final_state).mean()) - rates_j) < 0.03


# ---- the plain (kernel) step against the torch engine --------------------------------


@pytest.mark.parametrize("rs", [None, (1.0, 1.5, 2.5)])
def test_plain_step_matches_torch_engine_on_the_same_noise(rs):
    """The torch engine draws the replicas' normals and Exp(1) (one batched
    inner step, or one per replica with ``replica_scales``) and the two
    sweeps' uniforms from one generator; the same numbers, replayed from a
    copy of it, drive the plain step. The engine tempers lp and computes ℓ =
    lp/β, the kernel carries ℓ: states and ℓ agree to 1e-6. The engine's
    accept flags travel with the swaps (as JAX's), so the plain step's move
    decisions are swapped alike before they are compared."""
    C, betas, scale = 64, (1.0, 0.5, 0.2), 0.6
    model = gaussian_mean_scale_model(device="cpu")
    pt = ReplicaExchange(RWMH(MvNormal(torch.zeros(2), scale=scale)), betas=betas,
                         replica_scales=rs)
    K = len(betas)
    _, state = pt.init_batched(torch.Generator().manual_seed(0), model, (C,),
                               torch.tensor([0.0, 1.0]))
    x = [state.inner.params[:, k].T.contiguous() for k in range(K)]
    ell = [model.tile_density(v, *model.tile_consts) for v in x]
    b, db, sc = ladder_constants(betas, scale, 2, rs, "cpu")
    for t in range(15):
        gen = torch.Generator().manual_seed(50 + t)
        replay = torch.Generator()
        replay.set_state(gen.get_state())
        state = pt.step_batched(gen, state, model, (C,))[1]
        if rs is None:
            z = torch.randn((C, K, 2), generator=replay).permute(1, 2, 0)
            e = torch.empty((C, K)).exponential_(generator=replay).T
        else:
            draws = [(torch.randn((C, 1, 2), generator=replay)[:, 0].T,
                      torch.empty((C, 1)).exponential_(generator=replay)[:, 0]) for _ in betas]
            z, e = torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws])
        u = [torch.rand((C, K - 1), generator=replay) for _ in (0, 1)]
        logu_swap = torch.stack([torch.log(u[k % 2][:, k]) for k in range(K - 1)])
        moved, swaps = tempering_step(x, ell, z, -e, logu_swap, b, db, sc, model.tile_density,
                                      model.tile_consts)
        for parity in (0, 1):
            for k in range(parity, K - 1, 2):
                m = swaps[k]
                moved[k], moved[k + 1] = (torch.where(m, moved[k + 1], moved[k]),
                                          torch.where(m, moved[k], moved[k + 1]))
        np.testing.assert_array_equal(torch.cat(moved).T.numpy(), state.inner.accepted.numpy())
        np.testing.assert_allclose(torch.stack(x, 1).permute(2, 1, 0).numpy(),
                                   state.inner.params.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(torch.cat(ell).T.numpy(), (state.inner.lp / b).numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert float(swap_rates(state).mean()) > 0.1


def test_out_of_support_start_gives_no_nan():
    """Chains whose hot replicas start outside the flagship's support (σ < 0,
    ℓ = −inf) beside a cold replica inside it: a swap that is declined keeps
    both rows (the Pallas blend would write 0·(−inf) = NaN into ℓ)."""
    model = gaussian_mean_scale_model(device="cpu")
    C, K = 32, 4
    x = torch.cat([torch.tensor([[0.0] * C, [1.0] * C])] + [torch.tensor([[0.0] * C, [-2.0] * C])]
                  * (K - 1))
    ell = torch.cat([model.tile_density(x[2 * k:2 * k + 2], *model.tile_consts)
                     for k in range(K)])
    assert bool(torch.isinf(ell[1:]).all())
    out = tempering_sample_reference(model.tile_density, None, x, ell, model.tile_consts, 5,
                                     betas=(1.0, 0.6, 0.3, 0.1), scale=0.01, burn=0, thin=1,
                                     n_samples=5)
    for o in out:
        assert not bool(torch.isnan(o).any())
    assert bool(torch.isfinite(out[1]).all())


# ---- the fused engine on its plain version -------------------------------------------


def test_fused_bimodal_check_target():
    model = bimodal_mixture_model(device="cpu")
    pt = ReplicaExchange(RWMH(Normal(0.0, 0.5)), betas=BETAS)
    res = sample(model, pt, 1500, key=0, num_chains=64, engine="fused", discard_initial=300,
                 initial_params=torch.tensor([-5.0]))
    draws = res.transitions.params[..., 0].numpy()
    frac_right = (draws > 0).mean(axis=1)
    assert 0.3 < float(frac_right.mean()) < 0.7 and (frac_right > 0.02).mean() > 0.95
    want = model.tile_density(res.transitions.params.reshape(1, -1)).reshape(draws.shape)
    np.testing.assert_allclose(res.transitions.lp.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    rates = swap_rates(res.final_state).numpy()
    assert rates.shape == (64, 4) and (rates > 0.0).all() and (rates < 1.0).all()
    fs = res.final_state
    assert tuple(fs.inner.params.shape) == (64, 5, 1) and bool((fs.swap_proposal_count == 1799).all())
    np.testing.assert_array_equal(fs.inner.lp.numpy(),
                                  (fs.raw_lp * torch.tensor(BETAS, dtype=torch.float32)).numpy())


def test_fused_split_run_is_bit_exact_and_counts_proposals():
    """500 + 2 × 200 through initial_state + iteration_offset equals the
    unsplit run bit for bit; proposals count 499 + 200 + 200."""
    model = gaussian_mean_scale_model(device="cpu")
    pt = ReplicaExchange(RWMH(MvNormal(torch.zeros(2), scale=0.3)), betas=(1.0, 0.5, 0.2),
                         replica_scales=(1.0, 1.4, 2.2))
    kw = dict(key=8, num_chains=48, engine="fused")
    start = torch.tensor([0.0, 1.0])
    whole = sample(model, pt, 400, discard_initial=500, initial_params=start, **kw)
    first = sample(model, pt, 200, discard_initial=500, initial_params=start, **kw)
    rest = sample(model, pt, 200, discard_initial=1, initial_state=first.final_state,
                  iteration_offset=499 + 200, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f))
    assert bool((rest.final_state.swap_proposal_count == 499 + 200 + 200).all())
    assert torch.equal(rest.final_state.swap_accept_count, whole.final_state.swap_accept_count)


def test_fused_resumes_a_jax_state():
    """A JAX ReplicaExchangeState carried across as numpy resumes the port's
    torch engine and its fused engine (ℓ recomputed from the ladder)."""
    jpt = ref.ReplicaExchange(ref.RWMH(ref.Normal(0.0, 0.5)), betas=BETAS)
    jm = ref.DensityModel(lambda x: jnp.logaddexp(ref.Normal(-5.0, 1.0).log_prob(jnp.reshape(x, ())),
                                                  ref.Normal(5.0, 1.0).log_prob(jnp.reshape(x, ())))
                          - jnp.log(2.0), dimension=1)
    jres = ref.sample(jm, jpt, 50, key=jax.random.key(1), num_chains=8,
                      initial_params=jnp.asarray(-5.0), discard_initial=1)
    js = jres.final_state
    inner = transition_from_numpy(np.asarray(js.inner.params), np.asarray(js.inner.lp),
                                  np.asarray(js.inner.accepted), device="cpu")
    st = replica_exchange_state_from_numpy(inner, np.asarray(js.swap_accept_count),
                                           np.asarray(js.swap_proposal_count), device="cpu")
    assert tuple(st.inner.params.shape) == (8, 5) and st.raw_lp is None
    pt = ReplicaExchange(RWMH(Normal(0.0, 0.5)), betas=BETAS)
    model = bimodal_mixture_model(device="cpu")
    for engine in ("torch", "fused"):
        res = sample(model, pt, 30, key=2, num_chains=8, engine=engine, initial_state=st,
                     iteration_offset=51, discard_initial=1)
        assert bool(torch.isfinite(res.transitions.lp).all())
        assert bool((res.final_state.swap_proposal_count
                     == torch.as_tensor(np.asarray(js.swap_proposal_count)) + 30).all())


def test_fused_errors_and_wrapper_dispatch():
    model = gaussian_mean_scale_model(device="cpu")
    full = ReplicaExchange(RWMH(MvNormal(torch.zeros(2), scale_tril=torch.eye(2))),
                           betas=(1.0, 0.5))
    with pytest.raises(ValueError, match="scalar/diagonal"):
        sample(model, full, 5, key=0, num_chains=8, engine="fused",
               initial_params=torch.tensor([0.0, 1.0]))
    x = torch.zeros(2 * 33, 4)
    with pytest.raises(ValueError, match="K\\*d=66 > 64"):
        fused_tempering_sample(model.tile_density, None, x, torch.zeros(33, 4), (), 0,
                               betas=np.geomspace(1.0, 0.01, 33), scale=0.1, burn=0, thin=1,
                               n_samples=1)
    with pytest.raises(ValueError, match="replica_scales must have shape"):
        ladder_constants((1.0, 0.5), 0.1, 2, (1.0,), "cpu")
    x = torch.tensor([[0.0] * 8, [1.0] * 8] * 2)
    ell = torch.cat([model.tile_density(x[:2], *model.tile_consts)] * 2)
    fused_tempering_sample.launches = 0
    kw = dict(betas=(1.0, 0.5), scale=0.3, burn=2, thin=2, n_samples=3)
    got = fused_tempering_sample(model.tile_density, model.cuda_density, x, ell,
                                 model.tile_consts, 4, **kw)
    want = tempering_sample_reference(model.tile_density, None, x, ell, model.tile_consts, 4,
                                      **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_tempering_sample.launches == 0
