"""The evidence estimators of advancedmh_tpu_torch against advancedmh_tpu.

- ``power_ladder`` equal to JAX's; ``_evidence_estimates`` on the same
  draws equal to JAX's at rtol 1e-12 (float64 on both sides), warnings
  alike; ``_flatten_prior`` and ``_gaussian_prior_columns`` on Normal,
  MvNormal (scale, diagonal, triangular) and dict priors at float32
  tolerance, with the same errors;
- the likelihood models (conjugate Normal mean, flat, the logistic
  regression at ``prior_scale=inf``) against the JAX densities at float32
  tolerance;
- tests/test_evidence.py's assertions on the torch engine at their
  tolerances, and the port's log Z within 4 combined standard errors of
  JAX's XLA engine on the conjugate model;
- the kernel's plain version against the torch engine's ``power_step``,
  bit for bit, given the same noise, and the fused path (the plain version
  on CPU tensors) at tests/test_pallas.py's three evidence checks, at a
  reduced size;
- the decided semantics: β = 0 beside ll = −∞ rejects (NaN), and the fused
  engine reads the model's constants on every call (no tile cache to go
  stale).
"""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu.models import logistic_regression_model as jax_logreg
from advancedmh_tpu.runtime import evidence as jev
from advancedmh_tpu_torch import (InverseGamma, MvNormal, Normal, log_evidence,
                                  log_evidence_ais, power_ladder)
from advancedmh_tpu_torch.models import (flat_likelihood, logistic_regression_model,
                                         normal_mean_likelihood, normal_mean_tile)
from advancedmh_tpu_torch.ops import (fused_power_rwmh_sample, gaussian_prior_lp,
                                      power_rwmh_reference, power_step, step_noise)
from advancedmh_tpu_torch.runtime import evidence as pev

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


# ---- host parts against JAX ------------------------------------------------------


@pytest.mark.parametrize("n,c", [(16, 5.0), (11, 5.0), (32, 5.0), (7, 3.0)])
def test_power_ladder_equals_jax(n, c):
    assert power_ladder(n, c) == ref.power_ladder(n, c)
    assert power_ladder() == ref.power_ladder()


@pytest.mark.parametrize("min_acc", [0.1, 0.3])
def test_evidence_estimates_match_jax(min_acc):
    """Every output equal to JAX's at rtol 1e-12 on the same draws (both run
    in float64 on the host), and the low-acceptance warning raised alike."""
    rng = np.random.default_rng(0)
    betas = power_ladder(6)
    N, K, C = 40, len(betas), 12
    lls = (-3.0 - 2.0 * rng.random((N, K, C))).astype(np.float32)
    acc = np.asarray([0.5, 0.25, 0.2, 0.35, 0.12, 0.4])
    scales = np.linspace(1.0, 0.2, K)
    with warnings.catch_warnings(record=True) as w_p:
        warnings.simplefilter("always")
        got = pev._evidence_estimates(torch.tensor(lls), acc, scales, betas, N, C, min_acc)
    with warnings.catch_warnings(record=True) as w_j:
        warnings.simplefilter("always")
        want = jev._evidence_estimates(lls, acc, scales, betas, N, C, min_acc)
    assert [str(w.message) for w in w_p] == [str(w.message) for w in w_j]
    assert len(w_p) == (1 if min_acc == 0.3 else 0)
    for k in ("log_z_ss", "se_ss", "log_z_ti", "mean_loglik", "acceptance", "proposal_scales"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert got["betas"] == want["betas"]


def _priors():
    """(port prior, JAX prior, d) pairs: Normal, MvNormal (isotropic,
    diagonal, triangular) and a dict."""
    tril = np.asarray([[1.0, 0.0], [0.3, 0.5]], np.float32)
    return {
        "normal": (Normal(0.5, 2.0), ref.Normal(0.5, 2.0), 1),
        "mv_scale": (MvNormal(torch.tensor([0.1, -0.2, 0.3]), scale=1.5),
                     ref.MvNormal(jnp.asarray([0.1, -0.2, 0.3]), scale=1.5), 3),
        "mv_diag": (MvNormal(torch.zeros(2), scale_diag=torch.tensor([0.5, 2.0])),
                    ref.MvNormal(jnp.zeros(2), scale_diag=jnp.asarray([0.5, 2.0])), 2),
        "mv_tril": (MvNormal(torch.zeros(2), scale_tril=torch.tensor(tril)),
                    ref.MvNormal(jnp.zeros(2), scale_tril=jnp.asarray(tril)), 2),
        "dict": ({"a": Normal(0.0, 1.0), "b": MvNormal(torch.ones(2), scale=0.5)},
                 {"a": ref.Normal(0.0, 1.0), "b": ref.MvNormal(jnp.ones(2), scale=0.5)}, 3),
    }


@pytest.mark.parametrize("name", ["normal", "mv_scale", "mv_diag", "mv_tril", "dict"])
def test_flatten_prior_matches_jax(name):
    import jax

    prior_p, prior_j, d = _priors()[name]
    draw, lp_p, unravel, d_p = pev._flatten_prior(prior_p, "cpu")
    _, lp_j, unravel_j, d_j = jev._flatten_prior(prior_j, jax.random.PRNGKey(0))
    assert d_p == d_j == d
    pts = np.random.default_rng(1).normal(size=(50, d)).astype(np.float32)
    want = np.asarray(jax.vmap(lp_j)(jnp.asarray(pts)))
    np.testing.assert_allclose(lp_p(torch.tensor(pts)).numpy(), want, rtol=1e-5, atol=1e-5)
    x = draw(torch.Generator().manual_seed(0), 7)
    assert tuple(x.shape) == (7, d) and x.dtype == torch.float32
    tree = unravel(torch.tensor(pts))
    tree_j = jax.vmap(unravel_j)(jnp.asarray(pts))
    if name == "dict":
        for k in ("a", "b"):
            np.testing.assert_array_equal(tree[k].numpy(), np.asarray(tree_j[k]))
    else:
        np.testing.assert_array_equal(tree.numpy(), np.asarray(tree_j))


@pytest.mark.parametrize("name", ["normal", "mv_scale", "mv_diag", "mv_tril", "dict"])
def test_gaussian_prior_columns_match_jax(name):
    import jax

    prior_p, prior_j, _ = _priors()[name]
    if name == "mv_tril":
        with pytest.raises(ValueError, match="elementwise") as e_p:
            pev._gaussian_prior_columns(prior_p, "cpu")
        with pytest.raises(ValueError, match="elementwise"):
            jev._gaussian_prior_columns(prior_j, jax.random.PRNGKey(0))
        assert "scale_tril" in str(e_p.value)
        return
    loc, scale = pev._gaussian_prior_columns(prior_p, "cpu")
    loc_j, scale_j = jev._gaussian_prior_columns(prior_j, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(loc_j))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_j))


def test_prior_errors_match_jax():
    import jax

    with pytest.raises(ValueError, match="MvNormal prior"):
        pev._gaussian_prior_columns(InverseGamma(2.0, 3.0), "cpu")
    with pytest.raises(ValueError, match="MvNormal prior"):
        jev._gaussian_prior_columns(ref.InverseGamma(2.0, 3.0), jax.random.PRNGKey(0))
    for bad in (lambda x: 0.0, {"a": 1.0}, []):
        with pytest.raises(TypeError, match="Distribution"):
            pev._flatten_prior(bad, "cpu")


# ---- the likelihood models -----------------------------------------------------------


def test_likelihood_models_match_jax():
    """The conjugate Normal-mean and flat likelihoods and the logistic
    regression at prior_scale=inf against the JAX densities (float32
    tolerance): per chain, batched and tile."""
    import jax

    th = np.random.default_rng(2).normal(size=(64, 1)).astype(np.float32)
    m = normal_mean_likelihood(Y5, 0.7, **CPU)
    y_j = jnp.asarray(Y5)
    want = np.asarray(jax.vmap(lambda t: jnp.sum(ref.Normal(t[0], 0.7).log_prob(y_j)))(th))
    t = torch.tensor(th)
    np.testing.assert_allclose(m.logdensity_batched_fn(t).numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(m.tile_density(t.T, *m.tile_consts)[0].numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(float(m.logdensity_fn(t[3])), want[3], rtol=1e-5)
    assert m.cuda_density == "normal_mean" and m.dimension == 1

    f = flat_likelihood(2, **CPU)
    x = torch.tensor(np.random.default_rng(3).normal(size=(2, 9)), dtype=torch.float32)
    assert torch.equal(f.tile_density(x), torch.zeros(1, 9))
    assert torch.equal(f.logdensity_batched_fn(x.T), torch.zeros(9))
    assert f.cuda_density == "flat" and f.tile_consts == ()

    lm = logistic_regression_model(64, 4, seed=3, prior_scale=math.inf, **CPU)
    jm = jax_logreg(64, 4, seed=3, prior_scale=math.inf)
    assert float(lm.tile_consts[2]) == 0.0
    b = np.random.default_rng(4).normal(size=(20, 4)).astype(np.float32)
    want = np.asarray(jax.vmap(jm.logdensity_fn)(jnp.asarray(b)))
    bt = torch.tensor(b)
    np.testing.assert_allclose(lm.logdensity_batched_fn(bt).numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(lm.tile_density(bt.T, *lm.tile_consts)[0].numpy(), want,
                               rtol=1e-5, atol=1e-4)


# ---- tests/test_evidence.py on the torch engine ---------------------------------------


def test_normal_normal_evidence():
    out = log_evidence(normal_mean_likelihood(Y5, 1.0, **CPU), _prior1(), 3000, key=0,
                       num_chains=64, proposal_scale=0.6)
    want = _analytic_log_evidence(Y5, 1.0, 1.0)
    assert abs(out["log_z_ss"] - want) < 0.05
    assert abs(out["log_z_ti"] - want) < 0.1  # TI carries ladder bias
    assert out["se_ss"] > 0.0
    assert abs(out["log_z_ss"] - want) < 3.0 * out["se_ss"] + 0.02
    assert np.all(np.diff(out["mean_loglik"]) > -0.2)
    assert out["mean_loglik"][-1] > out["mean_loglik"][0] + 2.0
    assert np.all(out["acceptance"] > 0.05)


def test_flat_likelihood_gives_zero():
    """L ≡ 1 → log Z = 0 for both estimators; a plain function as JAX's."""
    out = log_evidence(lambda th: torch.zeros(()), MvNormal(torch.zeros(2), scale=1.0), 200,
                       key=1, num_chains=16, **CPU)
    assert abs(out["log_z_ss"]) < 1e-5
    assert abs(out["log_z_ti"]) < 1e-5


def test_two_dim_factorized():
    y1 = torch.tensor([0.5, -0.2, 0.9])
    y2 = torch.tensor([1.5, 2.1])

    def loglik(theta):
        return (torch.sum(Normal(theta[0], 1.0).log_prob(y1))
                + torch.sum(Normal(theta[1], 0.5).log_prob(y2)))

    out = log_evidence(loglik, MvNormal(torch.zeros(2), scale=1.0), 3000, key=2,
                       num_chains=64, proposal_scale=0.5, **CPU)
    want = (_analytic_log_evidence(y1.numpy(), 1.0, 1.0)
            + _analytic_log_evidence(y2.numpy(), 0.5, 1.0))
    assert abs(out["log_z_ss"] - want) < 0.08


def test_auto_scaling_keeps_every_rung_alive():
    out = log_evidence(normal_mean_likelihood(Y5, 0.05, **CPU), _prior1(), 2000, key=3,
                       num_chains=64)
    assert np.all(out["acceptance"] > 0.1)
    assert out["proposal_scales"][-1] < 0.5 * out["proposal_scales"][0]
    want = _analytic_log_evidence(Y5, 0.05, 1.0)
    assert abs(out["log_z_ss"] - want) < max(0.15, 3 * out["se_ss"])


def test_pytree_prior_params():
    y1 = torch.tensor([0.5, -0.2, 0.9])
    y2 = torch.tensor([1.5, 2.1])

    def loglik(theta):
        return (torch.sum(Normal(theta["a"], 1.0).log_prob(y1))
                + torch.sum(Normal(theta["b"], 0.5).log_prob(y2)))

    prior = {"a": Normal(0.0, 1.0), "b": Normal(0.0, 1.0)}
    out = log_evidence(loglik, prior, 3000, key=4, num_chains=64, **CPU)
    want = (_analytic_log_evidence(y1.numpy(), 1.0, 1.0)
            + _analytic_log_evidence(y2.numpy(), 0.5, 1.0))
    assert abs(out["log_z_ss"] - want) < max(0.1, 3 * out["se_ss"])


def test_low_acceptance_rung_warns():
    with pytest.warns(UserWarning, match="acceptance"):
        log_evidence(normal_mean_likelihood([0.3, 0.1], 0.005, **CPU), _prior1(), 300, key=5,
                     num_chains=16, proposal_scale=2.0)


def test_per_rung_scale_sequence():
    out = log_evidence(flat_likelihood(1, **CPU), _prior1(), 200, key=6, num_chains=16,
                       betas=(0.0, 0.5, 1.0), proposal_scale=(1.0, 0.5, 0.25))
    np.testing.assert_allclose(out["proposal_scales"], [1.0, 0.5, 0.25])


def test_argument_errors():
    flat = flat_likelihood(1, **CPU)
    with pytest.raises(ValueError, match="proposal_scale"):
        log_evidence(flat, _prior1(), 10, key=0, betas=(0.0, 1.0),
                     proposal_scale=(1.0, 0.5, 0.25))
    with pytest.raises(ValueError, match="betas"):
        log_evidence(flat, _prior1(), 10, key=0, betas=(0.0, 0.5))
    with pytest.raises(TypeError, match="Distribution"):
        log_evidence(flat, lambda x: 0.0, 10, key=0)
    with pytest.raises(ValueError, match="unknown proposal_scale"):
        log_evidence(flat, _prior1(), 10, key=0, proposal_scale="bogus")
    with pytest.raises(ValueError, match="engine='xla' belongs to the JAX package"):
        log_evidence(flat, _prior1(), 10, key=0, engine="xla")
    with pytest.raises(ValueError, match="Unknown engine"):
        log_evidence(flat, _prior1(), 10, key=0, engine="pallas")
    with pytest.raises(ValueError, match="TileDensityModel with a cuda_density"):
        log_evidence(lambda th: torch.zeros(()), _prior1(), 10, key=0, engine="fused", **CPU)


def test_entry_points_default_to_the_card():
    """A plain function runs on the card unless a device is given: with no
    card here, drawing the start on it fails rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        log_evidence(lambda th: torch.zeros(()), _prior1(), 10, key=0)
    with pytest.raises((RuntimeError, AssertionError)):
        log_evidence_ais(lambda th: torch.zeros(()), _prior1(), key=0)


def test_torch_engine_matches_jax_xla_engine():
    """The port's torch engine and JAX's XLA engine on the conjugate model,
    each with its own noise: log Z within 4·√(se² + se²)."""
    y_j = jnp.asarray(Y5)
    kw = dict(num_chains=64, proposal_scale=0.6)
    got = log_evidence(normal_mean_likelihood(Y5, 1.0, **CPU), _prior1(), 1000, key=11, **kw)
    want = ref.log_evidence(lambda th: jnp.sum(ref.Normal(th[0], 1.0).log_prob(y_j)),
                            ref.MvNormal(jnp.zeros(1), scale=1.0), 1000, key=11, **kw)
    tol = 4.0 * math.hypot(got["se_ss"], want["se_ss"])
    assert abs(got["log_z_ss"] - want["log_z_ss"]) < tol
    np.testing.assert_allclose(got["acceptance"], want["acceptance"], atol=0.03)


# ---- log_evidence_ais (tests/test_evidence.py::TestAIS) ----------------------------


def test_normal_normal_ais():
    out = log_evidence_ais(normal_mean_likelihood(Y5, 1.0, **CPU), _prior1(), key=0,
                           num_chains=512, n_steps_per_rung=4, proposal_scale=0.6)
    want = _analytic_log_evidence(Y5, 1.0, 1.0)
    assert abs(out["log_z_ais"] - want) < 0.05
    assert out["se_ais"] > 0.0
    assert abs(out["log_z_ais"] - want) < 3.0 * out["se_ais"] + 0.02
    assert out["ess_weights"] > 100.0
    assert np.all(out["acceptance"] > 0.1)


def test_ais_flat_likelihood_exact_zero():
    out = log_evidence_ais(lambda th: torch.zeros(()), MvNormal(torch.zeros(2), scale=1.0),
                           key=1, num_chains=32, n_steps_per_rung=1, betas=(0.0, 0.5, 1.0),
                           proposal_scale=1.0, **CPU)
    assert out["log_z_ais"] == 0.0
    assert out["ess_weights"] == pytest.approx(32.0)


def test_ais_auto_pilot_scales_monotone_shrink():
    out = log_evidence_ais(normal_mean_likelihood(np.zeros(50), 0.1, **CPU), _prior1(), key=2,
                           num_chains=256, n_steps_per_rung=3, n_pilot=300)
    s = out["proposal_scales"]
    assert s[-1] < 0.5 * s[0]
    want = _analytic_log_evidence(np.zeros(50, np.float32), 0.1, 1.0)
    assert abs(out["log_z_ais"] - want) < max(0.3, 4.0 * out["se_ais"])


def test_ais_pytree_prior():
    y1 = torch.tensor([0.5, -0.2, 0.9])

    def loglik(theta):
        return torch.sum(Normal(theta["mu"][0], 1.0).log_prob(y1))

    out = log_evidence_ais(loglik, {"mu": _prior1()}, key=3, num_chains=256,
                           proposal_scale=0.6, **CPU)
    want = _analytic_log_evidence(y1.numpy(), 1.0, 1.0)
    assert abs(out["log_z_ais"] - want) < 0.1


def test_ais_validation():
    flat = flat_likelihood(1, **CPU)
    with pytest.raises(ValueError, match="betas"):
        log_evidence_ais(flat, _prior1(), key=0, betas=(0.0, 0.5))
    with pytest.raises(ValueError, match="n_steps_per_rung"):
        log_evidence_ais(flat, _prior1(), key=0, n_steps_per_rung=0)
    with pytest.raises(ValueError, match="proposal_scale"):
        log_evidence_ais(flat, _prior1(), key=0, proposal_scale="bogus")
    with pytest.raises(ValueError, match="proposal_scale"):
        log_evidence_ais(flat, _prior1(), key=0, betas=(0.0, 1.0),
                         proposal_scale=(1.0, 0.5, 0.2))


def test_ais_low_acceptance_warns():
    with pytest.warns(UserWarning, match="ess_weights"):
        log_evidence_ais(normal_mean_likelihood(np.zeros(80), 0.05, **CPU), _prior1(), key=4,
                         num_chains=64, n_steps_per_rung=4, betas=(0.0, 0.1, 1.0),
                         proposal_scale=25.0)


# ---- the kernel's plain version and the fused path --------------------------------------


def _ladder_inputs(m, B, seed, d=1, scale=1.0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0.0, scale, (d, B)), dtype=torch.float32)
    loc, sc = torch.zeros(d), torch.full((d,), float(scale))
    beta = torch.tensor(rng.choice(power_ladder(8), B)[None], dtype=torch.float32)
    ll = m.tile_density(x, *m.tile_consts)
    plp = gaussian_prior_lp(x, loc[:, None], sc[:, None], torch.log(sc)[:, None])
    return x, ll, plp, beta, loc, sc


@pytest.mark.parametrize("burn,thin,n,offset", [(0, 1, 7, 0), (3, 2, 5, (1 << 32) - 4)])
def test_plain_kernel_equals_power_step(burn, thin, n, offset):
    """The kernel's plain version (no adaptation) against a loop of the torch
    engine's power_step fed the same noise: bit for bit."""
    m = normal_mean_likelihood(Y5, 1.0, **CPU)
    B = 96
    x, ll, plp, beta, loc, sc = _ladder_inputs(m, B, 5)
    eps0 = torch.full((1, B), 0.7)
    lls, accs, eps = fused_power_rwmh_sample(
        m.tile_density, m.cuda_density, x, ll, plp, beta, eps0, loc, sc, m.tile_consts, 77,
        n_samples=n, burn=burn, thin=thin, adapt=False, iteration_offset=offset)
    assert torch.equal(eps, eps0)
    loglik = lambda y: m.tile_density(y, *m.tile_consts)
    prior = lambda y: gaussian_prior_lp(y, loc[:, None], sc[:, None], torch.log(sc)[:, None])
    for s in range(1, burn + n * thin + 1):
        z, logu = step_noise(77, offset + s, 1, B, 1, "cpu")
        x, ll, plp, acc = power_step(x, ll, plp, beta, eps0, z[0], logu[0][None], loglik, prior)
        if s > burn and (s - burn) % thin == 0:
            e = (s - burn) // thin - 1
            assert torch.equal(lls[e], ll) and torch.equal(accs[e], acc.float())


def test_plain_kernel_adapts_per_chain():
    """With adaptation each chain's ε̄ moves from ε₀ toward the 0.234 target
    (smaller on the β = 1 rung than on the prior's), and a run's emissions
    do not depend on how the burn-in noise was chunked."""
    m = normal_mean_likelihood(Y5, 0.2, **CPU)
    B = 64
    x, ll, plp, _, loc, sc = _ladder_inputs(m, B, 6)
    beta = torch.cat([torch.zeros(1, B // 2), torch.ones(1, B // 2)], dim=1)
    eps0 = torch.full((1, B), 0.5)
    lls, accs, eps = power_rwmh_reference(
        m.tile_density, m.cuda_density, x, ll, plp, beta, eps0, loc, sc, m.tile_consts, 9,
        n_samples=200, burn=300)
    assert eps[0, B // 2:].median() < 0.5 * eps[0, :B // 2].median()
    assert 0.12 < float(accs.mean()) < 0.4
    assert lls.shape == (200, 1, B) and torch.isfinite(lls).all()


def test_zero_beta_beside_minus_inf_rejects():
    """β = 0 with ll = −inf: β·ll is NaN and every step rejects (both JAX
    engines' behaviour), in the kernel's plain version and in power_step."""
    m = normal_mean_likelihood(Y5, 1.0, **CPU)
    B = 8
    x, ll, plp, beta, loc, sc = _ladder_inputs(m, B, 7)
    ll[0, :2] = -math.inf
    beta[0, :2] = 0.0
    lls, accs, _ = fused_power_rwmh_sample(
        m.tile_density, m.cuda_density, x, ll, plp, beta, torch.full((1, B), 0.5), loc, sc,
        m.tile_consts, 3, n_samples=20, burn=5)
    assert torch.all(accs[:, 0, :2] == 0) and torch.all(lls[:, 0, :2] == -math.inf)
    assert float(accs[:, 0, 2:].mean()) > 0.1
    z = torch.ones(1, B)
    _, ll2, _, acc = power_step(x, ll, plp, beta, 0.1, z, torch.full((1, B), -50.0),
                                lambda y: m.tile_density(y, *m.tile_consts),
                                lambda y: torch.zeros(1, B))
    assert not acc[0, :2].any() and acc[0, 2:].all()


def test_wrapper_checks_its_inputs():
    m = normal_mean_likelihood(Y5, 1.0, **CPU)
    x, ll, plp, beta, loc, sc = _ladder_inputs(m, 16, 8)
    eps0 = torch.full((1, 16), 0.5)
    args = (m.tile_density, m.cuda_density)
    with pytest.raises(ValueError, match="beta must be"):
        fused_power_rwmh_sample(*args, x, ll, plp, beta[:, :8], eps0, loc, sc, m.tile_consts, 0,
                                n_samples=2, burn=1)
    with pytest.raises(ValueError, match=r"scale must be a float32 \(1,\)"):
        fused_power_rwmh_sample(*args, x, ll, plp, beta, eps0, loc, torch.ones(2),
                                m.tile_consts, 0, n_samples=2, burn=1)
    with pytest.raises(ValueError, match="non-negative"):
        fused_power_rwmh_sample(*args, x, ll, plp, beta, eps0, loc, sc, m.tile_consts, 0,
                                n_samples=0, burn=1)


def test_fused_conjugate_within_3se():
    """tests/test_pallas.py's fused conjugate check (closed form within
    3·se_ss + 0.02, TI within 0.1, every rung's acceptance in (0.15, 0.35))
    on the plain version, at 16 rungs × 64 chains × (1500 + 1500) where the
    card runs 16 × 256 × (3000 + 3000)."""
    out = log_evidence(normal_mean_likelihood(Y5, 1.0, **CPU), _prior1(), 1500, key=0,
                       num_chains=64, engine="fused")
    want = _analytic_log_evidence(Y5, 1.0, 1.0)
    assert abs(out["log_z_ss"] - want) < 3.0 * out["se_ss"] + 0.02
    assert abs(out["log_z_ti"] - want) < 0.1
    assert np.all(out["acceptance"] > 0.15) and np.all(out["acceptance"] < 0.35)


def test_fused_flat_likelihood_exact_zero():
    out = log_evidence(flat_likelihood(2, **CPU), MvNormal(torch.zeros(2), scale=1.0), 200,
                       key=1, num_chains=64, engine="fused")
    assert abs(out["log_z_ss"]) < 1e-5
    assert abs(out["log_z_ti"]) < 1e-5


def test_fused_non_gaussian_prior_rejected():
    with pytest.raises(ValueError, match="MvNormal prior"):
        log_evidence(flat_likelihood(1, **CPU), InverseGamma(2.0, 3.0), 100, key=2,
                     num_chains=64, engine="fused")


def test_fused_and_torch_engines_agree():
    """Both engines on the conjugate model (other noise, the same starts):
    log Z within 4 combined standard errors."""
    m = normal_mean_likelihood(Y5, 0.5, **CPU)
    kw = dict(num_chains=32, proposal_scale=0.5, betas=power_ladder(8))
    f = log_evidence(m, _prior1(), 800, key=12, engine="fused", **kw)
    t = log_evidence(m, _prior1(), 800, key=12, **kw)
    assert abs(f["log_z_ss"] - t["log_z_ss"]) < 4.0 * math.hypot(f["se_ss"], t["se_ss"])


def test_fused_reads_the_model_constants_every_call():
    """The JAX fused engine caches the lifted constants of a likelihood
    function (``_FUSED_TILES``, keyed on the function), so a second model
    with other data under the same function would reuse the first's. The
    port reads the model's ``tile_consts`` on every call: two models with
    one tile function, and the loglik_tile_fn keyword with other constants,
    each give their own data's evidence."""
    y_a = Y5
    y_b = np.asarray([-1.5, -0.9, -2.2], np.float32)
    kw = dict(num_chains=32, engine="fused", betas=power_ladder(8), proposal_scale=0.6)
    a = log_evidence(normal_mean_likelihood(y_a, 1.0, **CPU), _prior1(), 600, key=13, **kw)
    mb = normal_mean_likelihood(y_b, 1.0, **CPU)
    assert mb.tile_density is normal_mean_tile
    b = log_evidence(mb, _prior1(), 600, key=13, **kw)
    c = log_evidence(normal_mean_likelihood(y_a, 1.0, **CPU), _prior1(), 600, key=13,
                     loglik_tile_fn=normal_mean_tile, loglik_tile_consts=mb.tile_consts, **kw)
    want_a, want_b = (_analytic_log_evidence(y, 1.0, 1.0) for y in (y_a, y_b))
    assert abs(want_a - want_b) > 1.0
    assert abs(a["log_z_ss"] - want_a) < 4.0 * a["se_ss"] + 0.05
    assert abs(b["log_z_ss"] - want_b) < 4.0 * b["se_ss"] + 0.05
    assert abs(c["log_z_ss"] - want_b) < 4.0 * c["se_ss"] + 0.05
