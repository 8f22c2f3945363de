"""Adaptive-tempering SMC of advancedmh_tpu_torch against advancedmh_tpu.

- ``_systematic_resample`` against JAX's on the same weights and offset u₀:
  equal indices, except where a point lies within float32 rounding of a
  boundary of the cumulative weights;
- tests/test_smc.py's assertions on the port, at their tolerances;
- the port's log Z against JAX's, by the spread over seeds (neither returns
  a standard error: the JAX package's ``smc_sample`` has none, and the port
  mirrors it);
- the decided divergence: a stage forced by ``min_dbeta`` records the
  conditional-ESS fraction of the β it took (JAX records that of the
  smaller β the bisection chose).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.runtime import smc as jsmc
from advancedmh_tpu_torch import MvNormal, Normal, smc_sample
from advancedmh_tpu_torch.models import flat_likelihood, normal_mean_likelihood
from advancedmh_tpu_torch.runtime import smc as psmc

CPU = dict(device="cpu")
Y5 = np.asarray([0.8, 1.3, 0.2, 1.0, 0.6], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _analytic_log_evidence(y, sigma, tau):
    n = len(y)
    cov = sigma**2 * np.eye(n) + tau**2 * np.ones((n, n))
    _, logdet = np.linalg.slogdet(2.0 * np.pi * cov)
    return float(-0.5 * (logdet + y @ np.linalg.solve(cov, y)))


def _prior1(scale=1.0):
    return MvNormal(torch.zeros(1), scale=scale)


@pytest.mark.parametrize("n,spread", [(64, 1.0), (1000, 3.0), (4096, 30.0)])
def test_systematic_resample_matches_jax(n, spread):
    """The same indices as JAX's for the same log-weights and u₀ (JAX's own
    draw from its key), except where (u₀ + i)/n lies within float32 rounding
    of a cumulative weight: the two cumsums may round differently there."""
    rng = np.random.default_rng(n)
    logw = (spread * rng.normal(size=n)).astype(np.float32)
    key = jax.random.PRNGKey(n)
    want = np.asarray(jsmc._systematic_resample(key, jnp.asarray(logw), n))
    u0 = float(jax.random.uniform(key, ()))
    got = psmc._systematic_resample(torch.tensor(u0), torch.tensor(logw), n).numpy()
    assert got.min() >= 0 and got.max() <= n - 1
    cum = np.cumsum(np.exp(logw - logw.max()) / np.exp(logw - logw.max()).sum())
    pts = (np.float32(u0) + np.arange(n, dtype=np.float32)) / np.float32(n)
    near = np.min(np.abs(pts[:, None] - cum[None, :]), axis=1) < 1e-6 * max(1, n / 64)
    assert np.all((got == want) | near)
    assert np.mean(got == want) > 0.99


def test_resample_clamps_past_the_last_weight():
    """A cumsum that tops out below 1 sends the last points past the end;
    the index is clamped to n − 1."""
    logw = torch.tensor([0.0, -1e9, -1e9, -1e9])
    idx = psmc._systematic_resample(torch.tensor(0.999999), logw, 4)
    assert idx.tolist() == [0, 0, 0, 0]
    w = torch.tensor([0.1, 0.2, 0.3, 0.399])
    idx = psmc._systematic_resample(torch.tensor(0.9999), torch.log(w), 4)
    assert int(idx.max()) == 3


# ---- tests/test_smc.py ---------------------------------------------------------


def test_normal_normal_evidence_and_posterior():
    out = smc_sample(normal_mean_likelihood(Y5, 1.0, **CPU), _prior1(), key=0,
                     num_particles=8192)
    want = _analytic_log_evidence(Y5, 1.0, 1.0)
    assert abs(out["log_z"] - want) < 0.05
    n = len(Y5)
    th = out["particles"].numpy().reshape(-1)
    assert abs(th.mean() - Y5.sum() / (n + 1)) < 0.03
    assert abs(th.std() - (1.0 / (n + 1)) ** 0.5) < 0.03
    b = np.asarray(out["betas"])
    assert b[0] == 0.0 and b[-1] == 1.0
    assert np.all(np.diff(b) > 0)
    assert out["n_stages"] == len(b) - 1
    assert all(0.15 < a < 0.9 for a in out["acceptance"])


def test_flat_likelihood_exact():
    out = smc_sample(lambda th: torch.zeros(()), MvNormal(torch.zeros(2), scale=1.0), key=1,
                     num_particles=2048, **CPU)
    assert out["log_z"] == 0.0
    assert out["n_stages"] == 1
    p = out["particles"].numpy()
    np.testing.assert_allclose(p.mean(0), np.zeros(2), atol=0.08)
    np.testing.assert_allclose(p.std(0), np.ones(2), atol=0.08)


def test_schedule_resolution_follows_target():
    y = np.random.default_rng(0).normal(0.5, 1.0, 40).astype(np.float32)
    m = normal_mean_likelihood(y, 1.0, **CPU)
    fine = smc_sample(m, _prior1(), key=2, num_particles=2048, target_ess_frac=0.9)
    coarse = smc_sample(m, _prior1(), key=2, num_particles=2048, target_ess_frac=0.3)
    assert fine["n_stages"] > coarse["n_stages"]
    want = _analytic_log_evidence(y, 1.0, 1.0)
    assert abs(fine["log_z"] - want) < 0.1
    assert abs(coarse["log_z"] - want) < 0.15


def test_bimodal_mode_populations():
    sep = 6.0

    def loglik(theta):
        t = theta[0]
        return torch.logaddexp(-0.5 * ((t - sep / 2) / 0.5) ** 2,
                               -0.5 * ((t + sep / 2) / 0.5) ** 2)

    out = smc_sample(loglik, _prior1(4.0), key=3, num_particles=8192, mutation_steps=10, **CPU)
    th = out["particles"].numpy().reshape(-1)
    assert 0.4 < (th > 0).mean() < 0.6
    assert abs(np.abs(th).mean() - sep / 2) < 0.3


def test_pytree_prior():
    y1 = torch.tensor([0.5, -0.2, 0.9])
    y2 = torch.tensor([1.5, 2.1])

    def loglik(theta):
        return (torch.sum(Normal(theta["a"], 1.0).log_prob(y1))
                + torch.sum(Normal(theta["b"], 0.5).log_prob(y2)))

    prior = {"a": Normal(0.0, 1.0), "b": Normal(0.0, 1.0)}
    out = smc_sample(loglik, prior, key=4, num_particles=8192, **CPU)
    want = (_analytic_log_evidence(y1.numpy(), 1.0, 1.0)
            + _analytic_log_evidence(y2.numpy(), 0.5, 1.0))
    assert abs(out["log_z"] - want) < 0.1
    assert set(out["particles"].keys()) == {"a", "b"}
    assert tuple(out["particles"]["a"].shape) == (8192,)


def test_validation():
    flat = flat_likelihood(1, **CPU)
    with pytest.raises(ValueError, match="target_ess_frac"):
        smc_sample(flat, _prior1(), key=0, target_ess_frac=1.5)
    with pytest.raises(ValueError, match="mutation_steps"):
        smc_sample(flat, _prior1(), key=0, mutation_steps=0)
    with pytest.raises(TypeError, match="Distribution"):
        smc_sample(flat, lambda x: 0.0, key=0)


def test_non_finite_start_raises():
    def loglik(theta):
        return torch.where(theta[0] > 0, -theta[0] ** 2, torch.full_like(theta[0], -math.inf))

    with pytest.raises(ValueError, match="non-finite log-likelihood"):
        smc_sample(loglik, _prior1(), key=5, num_particles=256, **CPU)


def test_stalling_raises_past_max_stages():
    m = normal_mean_likelihood(np.zeros(50), 0.1, **CPU)
    with pytest.raises(RuntimeError, match="did not reach beta=1 in 2 stages"):
        smc_sample(m, _prior1(), key=6, num_particles=512, max_stages=2)


def test_deterministic_given_key():
    m = normal_mean_likelihood([0.3, 0.7], 1.0, **CPU)
    a = smc_sample(m, _prior1(), key=7, num_particles=512)
    b = smc_sample(m, _prior1(), key=7, num_particles=512)
    assert a["log_z"] == b["log_z"] and a["betas"] == b["betas"]
    assert torch.equal(a["particles"], b["particles"])


# ---- against JAX, and the forced-stage divergence -----------------------------------


def test_log_z_matches_jax_over_seeds():
    """Neither package returns an SE for SMC: the means of log Z over 6 seeds
    each agree within 4 standard errors of the difference of means, and both
    sit near the closed form."""
    y = np.asarray([0.8, 1.3, 0.2, 1.0, 0.6, -0.4, 1.9], np.float32)
    m = normal_mean_likelihood(y, 0.7, **CPU)
    y_j = jnp.asarray(y)
    jl = lambda th: jnp.sum(ref.Normal(th[0], 0.7).log_prob(y_j))
    seeds = range(6)
    got = np.asarray([smc_sample(m, _prior1(), key=s, num_particles=1024)["log_z"]
                      for s in seeds])
    want = np.asarray([ref.smc_sample(jl, ref.MvNormal(jnp.zeros(1), scale=1.0), key=s,
                                      num_particles=1024)["log_z"] for s in seeds])
    se = math.sqrt(got.var(ddof=1) / len(got) + want.var(ddof=1) / len(want))
    assert abs(got.mean() - want.mean()) < 4.0 * se + 1e-3
    truth = _analytic_log_evidence(y, 0.7, 1.0)
    assert abs(got.mean() - truth) < 0.05 and abs(want.mean() - truth) < 0.05


def test_forced_stage_records_the_ess_of_the_beta_taken():
    """A tiny target ESS on a sharp likelihood picks a first β step below
    min_dbeta = 0.25, so that stage is forced to β = 0.25. The port records
    the conditional-ESS fraction at the β taken (far below the target), JAX
    the one at the β its bisection chose (at the target)."""
    m = normal_mean_likelihood(np.zeros(50), 0.02, **CPU)
    kw = dict(num_particles=1024, target_ess_frac=0.02, min_dbeta=0.25)
    out = smc_sample(m, _prior1(), key=8, **kw)
    assert out["betas"][:2] == (0.0, 0.25)
    # the first stage's weights, from the port's own initial draws
    from advancedmh_tpu_torch.runtime.evidence import _flatten_prior
    from advancedmh_tpu_torch.utils.keys import step_generator

    draw = _flatten_prior(_prior1(), "cpu")[0]
    ll0 = m.logdensity_batched_fn(draw(step_generator(8, 0, "cpu"), 1024))
    want = float(torch.exp(psmc._cess(torch.tensor(0.25), ll0)) / 1024)
    assert out["ess_frac"][0] == pytest.approx(want, rel=1e-6)
    assert out["ess_frac"][0] < 0.5 * kw["target_ess_frac"]

    y_j = jnp.zeros(50)
    jl = lambda th: jnp.sum(ref.Normal(th[0], 0.02).log_prob(y_j))
    jout = ref.smc_sample(jl, ref.MvNormal(jnp.zeros(1), scale=1.0), key=8, **kw)
    assert jout["betas"][:2] == (0.0, 0.25)
    assert jout["ess_frac"][0] == pytest.approx(kw["target_ess_frac"], rel=0.05)
