"""``sample(..., vectorized=...)`` in advancedmh_tpu_torch against advancedmh_tpu,
and tests/test_vectorized.py's checks on the torch engine.

``vectorized=True`` runs the batched path (the chains a batch dimension of
every tensor), ``False`` the sequential one (chain c from ``fold_in(key,
c)``, as ``MCMCSerial()``), ``None`` the path ``chain_method`` names. The two
agree in distribution, not draw for draw, so these tests hold:

- the model against tests/test_mh.py's JAX model (1e-5);
- for every (``vectorized``, ``chain_method``) pair, that the port takes
  the path JAX's ``sample`` takes (batched or one chain at a time), each
  package's run told apart by equality with its own two reference runs;
- each path's posterior means and standard deviations of μ and σ against
  JAX's run of the same path, within 5 Monte Carlo standard errors (from
  the spread of the 32 independent chains' own statistics);
- posterior moments at the JAX test's tolerances, the two paths against
  each other, and exact resume inside each path.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
from advancedmh_tpu_torch import (MALA, RWMH, DensityModel, MCMCSerial, MCMCThreads,
                                  MetropolisHastings, MvNormal, Normal, RandomWalkProposal,
                                  RobustAdaptiveMetropolis, StaticMH, sample)
from advancedmh_tpu_torch.convert import gaussian_mean_scale_from_numpy
from tests.test_mh import MODEL as JAX_MODEL

# tests/test_mh.py's MODEL: the (μ, σ) Gaussian with 300 observations from
# N(0, 1) and the σ ≥ 0 support guard
MODEL = gaussian_mean_scale_from_numpy(np.random.default_rng(1234).normal(size=300),
                                       device="cpu")
NAMES = ["μ", "σ"]
# the moment runs of both packages: RWMH(0.1) from (0, 1), key 1
MOMENT_KW = dict(num_chains=32, discard_initial=500)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rwmh():
    return RWMH(MvNormal(torch.zeros(2), scale=0.1))


def _jax_rwmh():
    return ref.RWMH(ref.MvNormal(jnp.zeros(2), scale=0.1))


@functools.lru_cache(maxsize=None)
def _moment_draws(package: str, vectorized: bool) -> np.ndarray:
    """The (32, 2000, 2) draws of the moment run of ``package`` on one path."""
    if package == "jax":
        res = ref.sample(JAX_MODEL, _jax_rwmh(), 2000, key=1, vectorized=vectorized,
                         initial_params=jnp.asarray([0.0, 1.0]), **MOMENT_KW)
    else:
        res = sample(MODEL, _rwmh(), 2000, key=1, vectorized=vectorized,
                     initial_params=[0.0, 1.0], **MOMENT_KW)
    return np.asarray(res.transitions.params, np.float64)


def _chain_stats(draws: np.ndarray):
    """The mean over chains of each chain's means and standard deviations
    (μ, σ) and their standard errors, from the spread over the chains."""
    per = np.concatenate([draws.mean(axis=1), draws.std(axis=1)], axis=1)  # (chains, 4)
    return per.mean(axis=0), per.std(axis=0, ddof=1) / math.sqrt(per.shape[0])


def test_model_is_the_jax_tests_model():
    pts = np.array([[0.0, 1.0], [0.3, 0.7], [-0.2, 1.4], [0.1, -0.5]], np.float32)
    got = [float(MODEL.logdensity(torch.as_tensor(t))) for t in pts]
    want = [float(JAX_MODEL.logdensity(jnp.asarray(t))) for t in pts]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _path(runs: dict, got: np.ndarray) -> str:
    """Which of a package's reference runs ``got`` equals, draw for draw."""
    hits = [name for name, want in runs.items() if np.array_equal(got, want)]
    assert len(hits) == 1, hits
    return hits[0]


@functools.lru_cache(maxsize=None)
def _flag_run(package: str, vectorized, method: str) -> np.ndarray:
    """4 chains x 40 draws of RWMH(0.1) from (0, 1), key 2."""
    if package == "jax":
        cm = {"default": None, "threads": ref.MCMCThreads(), "serial": ref.MCMCSerial()}
        res = ref.sample(JAX_MODEL, _jax_rwmh(), 40, key=2, num_chains=4,
                         initial_params=jnp.asarray([0.0, 1.0]), vectorized=vectorized,
                         chain_method=cm[method])
    else:
        cm = {"default": None, "threads": MCMCThreads(), "serial": MCMCSerial()}
        res = sample(MODEL, _rwmh(), 40, key=2, num_chains=4, initial_params=[0.0, 1.0],
                     vectorized=vectorized, chain_method=cm[method])
    return np.asarray(res.transitions.params)


@pytest.mark.parametrize("method", ["default", "threads", "serial"])
@pytest.mark.parametrize("vectorized", [None, True, False])
def test_flag_takes_the_path_jax_takes(vectorized, method):
    """JAX batches when ``vectorized`` is True, or None with a batching chain
    method; else it runs each chain alone (vmapped or one after another, the
    same draws). Each package's run is named by the reference run of its own
    it equals, and the names must agree."""
    names = {}
    for package in ("jax", "torch"):
        runs = {"batched": _flag_run(package, True, "default"),
                "one chain at a time": _flag_run(package, False, "serial")}
        assert not np.array_equal(runs["batched"], runs["one chain at a time"])
        names[package] = _path(runs, _flag_run(package, vectorized, method))
    assert names["torch"] == names["jax"]


@pytest.mark.parametrize("vectorized", [True, False])
def test_flag_path_moments_match_jax(vectorized):
    """Posterior means and standard deviations of μ and σ on each path
    against JAX's run of the same path, within 5 combined standard errors;
    the errors are small enough that this is far tighter than the 0.05 the
    paths are held to against each other."""
    m_j, se_j = _chain_stats(_moment_draws("jax", vectorized))
    m_t, se_t = _chain_stats(_moment_draws("torch", vectorized))
    tol = 5.0 * np.sqrt(se_j ** 2 + se_t ** 2)
    assert (tol < 0.01).all(), tol
    np.testing.assert_array_less(np.abs(m_t - m_j), tol)


def test_moments_with_the_default_path():
    spl = StaticMH([Normal(0.0, 1.0), Normal(0.0, 1.0)])
    c = sample(MODEL, spl, 3000, key=0, num_chains=32, discard_initial=500,
               chain_type="chains", param_names=NAMES)
    assert abs(float(c["μ"].mean())) < 0.1
    assert abs(float(c["σ"].mean()) - 1.0) < 0.1


def test_flag_paths_agree_statistically():
    vec, seq = _moment_draws("torch", True), _moment_draws("torch", False)
    assert abs(vec[..., 0].mean() - seq[..., 0].mean()) < 0.05
    assert abs(vec[..., 1].mean() - seq[..., 1].mean()) < 0.05


@pytest.mark.parametrize("vectorized,same_as,batched", [
    (True, dict(), True), (False, dict(chain_method=MCMCSerial()), False),
    (None, dict(chain_method="sequential"), False),
])
def test_flag_selects_the_path(vectorized, same_as, batched):
    """True is the default batched path, False the sequential one (chain c
    from fold_in(key, c)), None leaves the choice to chain_method; the two
    paths draw differently."""
    kw = dict(key=2, num_chains=4, initial_params=[0.0, 1.0])
    flag = sample(MODEL, _rwmh(), 40, vectorized=vectorized, **kw, **same_as)
    same = sample(MODEL, _rwmh(), 40, **kw, **same_as)
    other = sample(MODEL, _rwmh(), 40, vectorized=not batched, **kw)
    assert torch.equal(flag.transitions.params, same.transitions.params)
    assert not torch.equal(flag.transitions.params, other.transitions.params)
    assert tuple(flag.transitions.params.shape) == (4, 40, 2)


def test_flag_overrides_chain_method():
    kw = dict(key=2, num_chains=4, initial_params=[0.0, 1.0])
    a = sample(MODEL, _rwmh(), 20, vectorized=True, chain_method=MCMCSerial(), **kw)
    b = sample(MODEL, _rwmh(), 20, **kw)
    assert torch.equal(a.transitions.params, b.transitions.params)


@pytest.mark.parametrize("vectorized", [True, False])
def test_resume_is_bit_exact_inside_each_path(vectorized):
    kw = dict(key=3, num_chains=8, vectorized=vectorized)
    full = sample(MODEL, _rwmh(), 100, initial_params=[0.0, 1.0], **kw)
    p1 = sample(MODEL, _rwmh(), 50, initial_params=[0.0, 1.0], **kw)
    p2 = sample(MODEL, _rwmh(), 50, initial_state=p1.final_state,
                iteration_offset=p1.schedule.total_steps, discard_initial=1, **kw)
    for f in ("params", "lp"):
        assert torch.equal(getattr(full.transitions, f),
                           torch.cat([getattr(p1.transitions, f),
                                      getattr(p2.transitions, f)], 1))


def test_fused_engine_ignores_the_flag():
    kw = dict(key=4, num_chains=64, initial_params=[0.0, 1.0], engine="fused")
    a = sample(MODEL, _rwmh(), 20, vectorized=False, **kw)
    b = sample(MODEL, _rwmh(), 20, **kw)
    assert torch.equal(a.transitions.params, b.transitions.params)


def test_mala_moments():
    s2 = 1e-3
    spl = MALA(lambda g: MvNormal(s2 / 2.0 * g, scale=math.sqrt(s2)))
    c = sample(MODEL, spl, 2000, key=4, num_chains=16, initial_params=[1.0, 1.0],
               discard_initial=500, chain_type="chains", param_names=NAMES)
    assert abs(float(c["μ"].mean())) < 0.1
    assert abs(float(c["σ"].mean()) - 1.0) < 0.1


def _gauss(sig):
    mv = MvNormal.from_cov(torch.zeros(2), torch.as_tensor(sig))
    return DensityModel(mv.log_prob, dimension=2, device="cpu")


def test_ram_covariance_recovery():
    sig = np.array([[1.0, 0.5], [0.5, 1.0]], dtype=np.float32)
    res = sample(_gauss(sig), RobustAdaptiveMetropolis(), 3000, key=5, num_chains=8,
                 num_warmup=3000, initial_params=[0.0, 0.0])
    draws = res.transitions.params.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(draws.T), sig, rtol=0.2, atol=0.1)


def test_ram_eigenvalue_bounds_batched():
    sig = np.array([[10.0, 5.0], [5.0, 10.0]], dtype=np.float32)
    spl = RobustAdaptiveMetropolis(gamma=0.51, eigenvalue_lower_bound=0.9,
                                   eigenvalue_upper_bound=1.1)
    res = sample(_gauss(sig), spl, 500, key=6, num_chains=4, num_warmup=500,
                 discard_initial=0, initial_params=[0.0, 0.0], collect_states=True)
    diags = torch.diagonal(res.states.S, dim1=-2, dim2=-1).numpy()  # (chains, n, 2)
    assert (diags >= 0.9 - 1e-5).all() and (diags <= 1.1 + 1e-5).all()
    assert np.isclose(diags.max(axis=1), 1.1, atol=0.05).all()


def test_state_dependent_proposal():
    m = DensityModel(lambda x: Normal(0.0, 1.0).log_prob(x), device="cpu")
    spl = MetropolisHastings(
        RandomWalkProposal(lambda t=0.0: Normal(0.0, 0.5 + 0.1 * torch.tanh(torch.as_tensor(t)))))
    c = sample(m, spl, 2000, key=7, num_chains=32, discard_initial=200, chain_type="chains")
    assert abs(float(c.values.mean())) < 0.1
