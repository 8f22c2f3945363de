"""Differential-evolution MCMC in advancedmh_tpu_torch against advancedmh_tpu.

- ``_gamma`` and the snooker proposal with its log Jacobian against JAX's
  expressions on the same members (1e-6);
- ``de_move`` fed the draws JAX's key splits give, against JAX's
  ``_half_move`` (decisions equal, states 1e-5);
- the plain (kernel) half-move against the torch engine's on the same
  noise (decisions equal, states 1e-6);
- tests/test_demc.py's assertions on the torch engine, at their tolerances
  (fewer steps), and moments within 4 combined MCSE of the JAX XLA
  engine's;
- the fused engine on its plain version: one population of any even
  M >= 6 (1000 members run, where the JAX engine raises), the posterior,
  a split run bit for bit, the wrapper's plain dispatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu_torch import (DensityModel, DifferentialEvolution, InverseGamma, MvNormal,
                                  Normal, ess_bulk, sample)
from advancedmh_tpu_torch.models import correlated_gaussian_model, emcee_demo_model
from advancedmh_tpu_torch.ops import (DemcParams, demc_move, demc_sample_reference,
                                      fused_demc_sample)
from advancedmh_tpu_torch.ops.demc import snooker_move

S_TRUE = 49.0 / 24.0
M_TRUE = 7.0 / 6.0
PRIOR = [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]
COV = np.array([[1.5, 0.9], [0.9, 1.0]], np.float32)


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


MODEL = DensityModel(_logprob_untransformed, device="cpu")
PREC = np.linalg.inv(COV).astype(np.float32)


def _quadratic():
    P, jP = torch.as_tensor(PREC), jnp.asarray(PREC)
    return (DensityModel(lambda th: -0.5 * th @ P @ th, dimension=2, device="cpu"),
            ref.DensityModel(lambda th: -0.5 * th @ jP @ th, dimension=2))


# ---- γ and the snooker term -----------------------------------------------------------


def test_gamma_matches_jax():
    for d in (1, 2, 3, 10, 32):
        for g in (None, 0.7):
            ours = DifferentialEvolution(8, Normal(0.0, 1.0), gamma=g)._gamma(d)
            theirs = ref.DifferentialEvolution(8, ref.Normal(0.0, 1.0), gamma=g)._gamma(d)
            assert ours == theirs and np.float32(ours) == np.float32(theirs)


def _jax_snooker(x, x1, x2, xz, d, gs):
    """JAX's snooker expressions (advancedmh_tpu/samplers/demc.py:184-204)."""
    e = x - xz
    ee = jnp.sum(e * e, axis=1)
    safe = ee > 1e-30
    coef = gs * jnp.sum((x1 - x2) * e, axis=1) * jnp.where(safe, 1.0 / jnp.maximum(ee, 1e-30),
                                                          0.0)
    y = x + coef[:, None] * e
    ee_y = jnp.sum((y - xz) ** 2, axis=1)
    log_j = jnp.where(safe & (ee_y > 1e-30),
                      0.5 * (d - 1) * (jnp.log(jnp.maximum(ee_y, 1e-30))
                                       - jnp.log(jnp.maximum(ee, 1e-30))), -jnp.inf)
    return np.asarray(y), np.asarray(log_j)


@pytest.mark.parametrize("d", [2, 3, 5])
def test_snooker_term_matches_jax(d):
    """The torch engine's snooker_proposal and the kernels' snooker_move on
    the same members: y and the log Jacobian at 1e-6; x = z (the direction
    undefined) gives −inf there and −1e30 in the kernels, both rejected."""
    rng = np.random.default_rng(d)
    n = 40
    x, x1, x2, xz = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(4))
    xz[:3] = x[:3]
    want_y, want_j = _jax_snooker(*(jnp.asarray(a) for a in (x, x1, x2, xz)), d, 1.683)
    spl = DifferentialEvolution(8, Normal(0.0, 1.0))
    t = lambda a: torch.as_tensor(a)
    y, log_j = spl.snooker_proposal(t(x), t(x1), t(x2), t(xz), d)
    np.testing.assert_allclose(y.numpy(), want_y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(log_j.numpy(), want_j, rtol=1e-6, atol=1e-6)
    yk, jk = snooker_move(t(x.T), t((x1 - x2).T), t(xz.T), torch.tensor(1.683),
                          torch.tensor(0.5 * (d - 1)))
    np.testing.assert_allclose(yk.T.numpy(), want_y, rtol=1e-5, atol=1e-5)
    ok = np.isfinite(want_j)
    np.testing.assert_allclose(jk[0].numpy()[ok], want_j[ok], rtol=1e-5, atol=1e-5)
    assert not ok[:3].any() and bool((jk[0, :3] == -1e30).all())


# ---- the torch engine's move against JAX's on its draws ----------------------------


def _jax_draws(key, n, H, snooker):
    key_r1, key_r2, key_j, key_eps, key_acc, key_z, key_s = jax.random.split(key, 7)
    draws = dict(r1=jax.random.randint(key_r1, (n,), 0, H),
                 r2=jax.random.randint(key_r2, (n,), 0, H - 1),
                 u_j=jax.random.uniform(key_j, (n,)),
                 eps=1e-4 * jax.random.normal(jax.random.split(key_eps, 1)[0], (n, 2)),
                 e=jax.random.exponential(key_acc, (n,)))
    if snooker:
        draws.update(z=jax.random.randint(key_z, (n,), 0, H - 2),
                     u_s=jax.random.uniform(key_s, (n,)))
    return {k: torch.as_tensor(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("snooker", [0.0, 0.4])
@pytest.mark.parametrize("target", ["emcee", "quadratic"])
def test_de_move_matches_jax_half_move(snooker, target):
    H = 32
    rng = np.random.default_rng(7)
    if target == "emcee":
        pm = MODEL
        jm = ref.DensityModel(lambda th: jnp.where(
            th[0] > 0, ref.InverseGamma(2.0, 3.0).log_prob(jnp.maximum(th[0], 1e-6))
            + ref.Normal(0.0, jnp.sqrt(jnp.maximum(th[0], 1e-6))).log_prob(th[1])
            + ref.Normal(th[1], jnp.sqrt(jnp.maximum(th[0], 1e-6))).log_prob(1.5)
            + ref.Normal(th[1], jnp.sqrt(jnp.maximum(th[0], 1e-6))).log_prob(2.0), -jnp.inf))
        x = np.stack([rng.uniform(0.3, 4.0, 2 * H), rng.normal(1.0, 1.0, 2 * H)], 1)
    else:
        pm, jm = _quadratic()
        x = rng.normal(size=(2 * H, 2))
    x = x.astype(np.float32)
    jspl = ref.DifferentialEvolution(2 * H, ref.Normal(0.0, 1.0), snooker_probability=snooker,
                                     jump_probability=0.3)
    pspl = DifferentialEvolution(2 * H, Normal(0.0, 1.0), snooker_probability=snooker,
                                 jump_probability=0.3)
    lp = np.array(jax.vmap(jm.logdensity_fn)(jnp.asarray(x)))
    for i in range(4):
        key = jax.random.key(30 + i)
        jx, jlp, jacc = jspl._half_move(key, jnp.asarray(x[:H]), jnp.asarray(lp[:H]),
                                        jnp.asarray(x[H:]), jnp.asarray(lp[H:]), jm)
        dr = _jax_draws(key, H, H, snooker > 0)
        px, plp, pacc = pspl.de_move(
            torch.as_tensor(x[:H]), torch.as_tensor(lp[:H]), torch.as_tensor(x[H:]), dr["r1"],
            dr["r2"], dr["u_j"] < 0.3, dr["eps"], dr.get("z"),
            dr["u_s"] < snooker if snooker else None, dr["e"], pm)
        np.testing.assert_array_equal(pacc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-5)
        assert 0 < int(pacc.sum()) < H
        x[:H], lp[:H] = px.numpy(), plp.numpy()


# ---- the plain (kernel) move against the torch engine -------------------------------


@pytest.mark.parametrize("snooker", [0.0, 0.5])
def test_plain_move_matches_torch_engine_on_the_same_noise(snooker):
    """The torch engine's step draws, per half, r1, r2, the jump uniforms,
    the noise, (z and the snooker uniforms) and Exp(1) from one generator;
    the same numbers, replayed from a copy, drive the kernels' demc_move."""
    M, H = 128, 64
    model = correlated_gaussian_model(COV, device="cpu")
    spl = DifferentialEvolution(M, MvNormal.standard(2, device="cpu"), jump_probability=0.2,
                                snooker_probability=snooker)
    prm = DemcParams(spl._gamma(2), spl.noise_scale, spl.jump_probability,
                     spl.snooker_probability, spl.snooker_gamma)
    _, state = spl.init(torch.Generator().manual_seed(0), model)
    x = state.params.T.contiguous()
    lp = model.tile_density(x, *model.tile_consts)
    halves = torch.arange(M).view(2, H)
    for t in range(8):
        gen = torch.Generator().manual_seed(10 + t)
        replay = torch.Generator()
        replay.set_state(gen.get_state())
        state = spl.step(gen, state, model)[1]
        accs = []
        for h in (0, 1):
            r1 = torch.randint(0, H, (H,), generator=replay)
            r2 = torch.randint(0, H - 1, (H,), generator=replay)
            jump = torch.rand((H,), generator=replay) < spl.jump_probability
            z = torch.randn((H, 2), generator=replay)
            rz = pick = None
            r2 = r2 + (r2 >= r1).to(r2.dtype)
            if snooker:
                rz = torch.randint(0, H - 2, (H,), generator=replay)
                pick = (torch.rand((H,), generator=replay) < snooker)[None]
                lo, hi = torch.minimum(r1, r2), torch.maximum(r1, r2)
                rz = rz + (rz >= lo).to(rz.dtype)
                rz = rz + (rz >= hi).to(rz.dtype)
            e = torch.empty((H,)).exponential_(generator=replay)
            accs.append(demc_move(x, lp, halves[h], (1 - h) * H, r1, r2, jump[None], z.T, rz,
                                  pick, -e[None], prm, model.tile_density, model.tile_consts))
        np.testing.assert_array_equal(torch.cat(accs, 1)[0].numpy(), state.accepted.numpy())
        np.testing.assert_allclose(x.T.numpy(), state.params.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(lp[0].numpy(), state.lp.numpy(), rtol=1e-6, atol=1e-6)


# ---- tests/test_demc.py on the torch engine -------------------------------------------


class TestDEMCTorchEngine:
    def test_conjugate_means(self):
        chains = sample(MODEL, DifferentialEvolution(1000, PRIOR), 600, key=100,
                        chain_type="chains", param_names=["s", "m"], discard_initial=200)
        assert chains.n_chains == 1000  # members as chains (the 3-D path)
        assert abs(float(chains["s"].mean()) - S_TRUE) < 0.1
        assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1

    def test_correlated_gaussian_covariance(self):
        model, _ = _quadratic()
        res = sample(model, DifferentialEvolution(512, MvNormal.standard(2, device="cpu")), 1000,
                     key=7, discard_initial=500)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.2)

    def test_conjugate_means_with_snooker(self):
        res = sample(MODEL, DifferentialEvolution(1000, PRIOR, snooker_probability=0.3), 600,
                     key=100, discard_initial=200)
        draws = res.transitions.params.reshape(-1, 2).numpy()
        assert abs(draws[:, 0].mean() - S_TRUE) < 0.1
        assert abs(draws[:, 1].mean() - M_TRUE) < 0.1

    def test_snooker_heavy_covariance(self):
        rng = np.random.default_rng(0)
        a = rng.normal(size=(3, 3)).astype(np.float32)
        cov = a @ a.T + 0.5 * np.eye(3, dtype=np.float32)
        prec = torch.as_tensor(np.linalg.inv(cov))
        model = DensityModel(lambda th: -0.5 * th @ prec @ th, dimension=3, device="cpu")
        spl = DifferentialEvolution(512, MvNormal.standard(3, device="cpu"),
                                    snooker_probability=0.7)
        res = sample(model, spl, 1500, key=9, discard_initial=1000)
        draws = res.transitions.params.reshape(-1, 3).numpy()
        np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.35 * float(np.abs(cov).max()))

    def test_snooker_pytree_params(self):
        model = DensityModel(lambda th: Normal(0.0, 1.0).log_prob(th["a"])
                             + torch.sum(Normal(0.0, 1.0).log_prob(th["b"])), device="cpu")
        spl = DifferentialEvolution(64, {"a": Normal(0.0, 1.0),
                                         "b": MvNormal.standard(3, device="cpu")},
                                    snooker_probability=0.4)
        res = sample(model, spl, 400, key=3, discard_initial=150)
        a, b = res.transitions.params["a"].numpy(), res.transitions.params["b"].numpy()
        assert abs(a.mean()) < 0.15
        assert abs(float(a.var()) - 1.0) < 0.3
        assert abs(b.mean()) < 0.15

    def test_bad_probability_raises(self):
        with pytest.raises(ValueError, match="snooker_probability"):
            DifferentialEvolution(8, Normal(0.0, 1.0), snooker_probability=1.5)

    def test_member_shapes_and_initial_params(self):
        spl = DifferentialEvolution(8, PRIOR)
        res = sample(MODEL, spl, 5, key=0)
        assert tuple(res.transitions.params.shape) == (5, 8, 2)
        assert tuple(res.transitions.lp.shape) == (5, 8)
        init = np.tile([2.0, 1.0], (6, 1))
        res = sample(MODEL, DifferentialEvolution(6, PRIOR), 3, key=0, initial_params=init,
                     discard_initial=0)
        np.testing.assert_allclose(res.transitions.params[0].numpy(), init)
        with pytest.raises(ValueError, match="n_members"):
            sample(MODEL, spl, 3, key=0, initial_params=np.tile([2.0, 1.0], (6, 1)))

    def test_odd_or_tiny_population_raises(self):
        with pytest.raises(ValueError, match="even"):
            DifferentialEvolution(7, Normal(0.0, 1.0))
        with pytest.raises(ValueError, match="even"):
            DifferentialEvolution(4, Normal(0.0, 1.0))

    def test_acceptance_happens(self):
        res = sample(MODEL, DifferentialEvolution(64, PRIOR), 100, key=1)
        assert 0.05 < float(res.transitions.accepted[1:].float().mean()) < 0.95

    def test_pytree_params(self):
        model = DensityModel(lambda th: Normal(0.0, 1.0).log_prob(th["a"])
                             + torch.sum(Normal(0.0, 1.0).log_prob(th["b"])), device="cpu")
        spl = DifferentialEvolution(64, {"a": Normal(0.0, 1.0),
                                         "b": MvNormal.standard(3, device="cpu")})
        res = sample(model, spl, 300, key=3, discard_initial=100)
        a, b = res.transitions.params["a"], res.transitions.params["b"]
        assert tuple(a.shape) == (300, 64) and tuple(b.shape) == (300, 64, 3)
        assert abs(float(a.mean())) < 0.15 and abs(float(b.mean())) < 0.15

    def test_mode_jump_hops_bimodal(self):
        def bimodal(th):
            return torch.logaddexp(
                MvNormal(torch.tensor([-4.0, 0.0]), scale=0.5).log_prob(th),
                MvNormal(torch.tensor([4.0, 0.0]), scale=0.5).log_prob(th))

        model = DensityModel(bimodal, dimension=2, device="cpu")
        base = np.tile([[-4.0, 0.0], [4.0, 0.0]], (64, 1)).astype(np.float32)
        res = sample(model, DifferentialEvolution(128, MvNormal.standard(2, device="cpu"),
                                                  jump_probability=0.2), 1000, key=11,
                     initial_params=base, discard_initial=100)
        x0 = res.transitions.params[..., 0].numpy()
        assert 0.25 < (x0[-1] > 0).mean() < 0.75
        assert ((x0[0] > 0) != (x0[-1] > 0)).mean() > 0.1


def test_moments_match_the_jax_xla_engine():
    pm, jm = _quadratic()
    jres = ref.sample(jm, ref.DifferentialEvolution(256, ref.MvNormal.standard(2)), 600,
                      key=jax.random.key(5), discard_initial=300)
    res = sample(pm, DifferentialEvolution(256, MvNormal.standard(2, device="cpu")), 600, key=5,
                 discard_initial=300)
    a = res.transitions.params.permute(1, 0, 2)  # (members, draws, d)
    b = torch.as_tensor(np.array(jres.transitions.params)).permute(1, 0, 2)
    for j in range(2):
        se = [float(torch.var(v[..., j])) / float(ess_bulk(v[..., j].T)) for v in (a, b)]
        assert abs(float(a[..., j].mean() - b[..., j].mean())) < 4.0 * (se[0] + se[1]) ** 0.5
    acc_j = float(np.asarray(jres.transitions.accepted).mean())
    assert abs(float(res.transitions.accepted.float().mean()) - acc_j) < 0.02


# ---- the fused engine on its plain version -------------------------------------------


def test_fused_posterior_thinning_and_snooker():
    model = emcee_demo_model(device="cpu")
    for snooker in (0.0, 0.3):
        res = sample(model, DifferentialEvolution(1024, PRIOR, snooker_probability=snooker), 1000,
                     key=100, engine="fused", discard_initial=200)
        draws = res.transitions.params.reshape(-1, 2)
        assert abs(float(draws[:, 0].mean()) - S_TRUE) < 0.1
        assert abs(float(draws[:, 1].mean()) - M_TRUE) < 0.1
        assert 0.1 < float(res.transitions.accepted.float().mean()) < 0.9
    assert tuple(res.transitions.params.shape) == (1000, 1024, 2)
    assert tuple(res.final_state.params.shape) == (1024, 2)
    res_t = sample(model, DifferentialEvolution(1024, PRIOR), 200, key=101, engine="fused",
                   discard_initial=100, thinning=3)
    draws = res_t.transitions.params.reshape(-1, 2)
    assert abs(float(draws[:, 0].mean()) - S_TRUE) < 0.12
    assert abs(float(draws[:, 1].mean()) - M_TRUE) < 0.12
    assert res_t.to_chains(param_names=["s", "m"]).range == range(101, 701, 3)


def test_fused_runs_one_population_of_any_even_size():
    """The JAX fused engine refuses 1000 members (a multiple of 256 is a
    lane rule, tests/test_demc.py:170-178); the port runs them, and M = 6."""
    model = emcee_demo_model(device="cpu")
    for M in (1000, 6):
        res = sample(model, DifferentialEvolution(M, PRIOR, snooker_probability=0.3), 10, key=0,
                     engine="fused")
        assert tuple(res.transitions.params.shape) == (10, M, 2)
        assert bool(torch.isfinite(res.transitions.lp).all())
    with pytest.raises(ValueError, match="even"):
        fused_demc_sample(model.tile_density, None, torch.ones(2, 7), torch.zeros(1, 7), (), 0,
                          params=DemcParams(0.5), burn=0, thin=1, n_samples=1)


def test_fused_split_run_is_bit_exact():
    model = emcee_demo_model(device="cpu")
    spl = DifferentialEvolution(48, PRIOR, snooker_probability=0.3)
    kw = dict(key=8, engine="fused", discard_initial=1)
    whole = sample(model, spl, 20, **kw)
    first = sample(model, spl, 10, **kw)
    second = sample(model, spl, 10, initial_state=first.final_state, iteration_offset=10, **kw)
    for f in ("params", "lp", "accepted"):
        assert torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(second.transitions, f)]),
                           getattr(whole.transitions, f))


def test_fused_wrapper_on_cpu_is_the_plain_version():
    model = emcee_demo_model(device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 3.0, (2, 32)).astype(np.float32))
    kw = dict(params=DemcParams(0.8, snooker_probability=0.2), burn=2, thin=2, n_samples=3)
    fused_demc_sample.launches = 0
    got = fused_demc_sample(model.tile_density, model.cuda_density, x, model.tile_density(x), (),
                            11, **kw)
    want = demc_sample_reference(model.tile_density, None, x, model.tile_density(x), (), 11,
                                 **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fused_demc_sample.launches == 0
    assert not torch.equal(got[0][-1], x)
