"""ESS / R̂ / MCSE and the Chains bundle of advancedmh_tpu_torch against
advancedmh_tpu on shared draws. rtol 1e-4: the FFTs sum in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import advancedmh_tpu as ref
import advancedmh_tpu_torch as port
from advancedmh_tpu.output.bundle import bundle_chains as ref_bundle_chains
from advancedmh_tpu.runtime.sample import SamplingResult as RefResult
from advancedmh_tpu.samplers.base import Transition as RefTransition
from advancedmh_tpu_torch.convert import transition_from_numpy
from advancedmh_tpu_torch.output import bundle_chains
from advancedmh_tpu_torch.runtime import SamplingResult

RTOL = 1e-4


def _ar1(n, c, phi, seed, shift=None):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, c))
    e = rng.normal(size=(n, c))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    if shift is not None:
        x = x + shift
    return x.astype(np.float32)


# one shape for all, so each JAX function compiles once
DRAWS = {
    "ar1": _ar1(256, 4, 0.7, 0),
    "heavy": np.random.default_rng(2).standard_t(2.5, size=(256, 4)).astype(np.float32),
    "shifted": _ar1(256, 4, 0.5, 3, shift=np.array([0.0, 0.0, 0.5, 0.5])),
}
FNS = ["ess", "rhat", "mcse", "ess_bulk", "ess_tail", "rhat_rank"]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_diagnostic_matches_jax(fn, name):
    x = DRAWS[name]
    got = float(getattr(port, fn)(torch.as_tensor(x)))
    want = float(jax.jit(getattr(ref, fn))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("fn", ["ess", "rhat", "ess_bulk"])
def test_single_chain_vector(fn):
    x = DRAWS["ar1"][:, 0]
    got = float(getattr(port, fn)(torch.as_tensor(x)))
    want = float(jax.jit(getattr(ref, fn))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def _repeated(n, c, p_repeat, seed):
    """MH-like draws: each step repeats the chain's last value with
    probability ``p_repeat`` (a rejection), so many draws tie."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    for t in range(1, n):
        stay = rng.uniform(size=c) < p_repeat
        x[t] = np.where(stay, x[t - 1], x[t])
    return x


@pytest.mark.parametrize("fn", ["ess_bulk", "rhat_rank"])
def test_rank_diagnostics_on_tied_draws_match_jax(fn):
    """Tied draws rank in order of position (a stable sort) in both
    packages; an unstable sort moved ess_bulk by 1.5e-3 relative here."""
    x = _repeated(256, 4, 0.7, 0)
    assert len(np.unique(x)) < 0.4 * x.size
    got = float(getattr(port, fn)(torch.as_tensor(x)))
    want = float(jax.jit(getattr(ref, fn))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_constant_draws_give_jax_floor_not_nan():
    """Zero variance in every chain: the NaN pair sums count as 0, τ takes
    its 1e-6 floor, ESS reads N·C/1e-6 = 4e8 as in JAX, and MCSE is 0.
    (JAX eagerly: under jit XLA rewrites the 0/0 of ρ and gives 2.57.)"""
    x = np.full((100, 4), 1.25, np.float32)
    got = float(port.ess(torch.as_tensor(x)))
    want = float(ref.ess(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, 4e8, rtol=1e-6)
    assert np.isfinite(float(port.mcse(torch.as_tensor(x))))
    assert np.isfinite(float(port.ess_tail(torch.as_tensor(x))))


def test_rank_clip_keeps_big_batches_finite():
    """More than 2²⁴ draws: the f32 clip keeps Φ⁻¹ finite (ess.py:103-110)."""
    from advancedmh_tpu_torch.diagnostics.ess import _rank_normalize

    x = torch.randn(1024, 16385, generator=torch.Generator().manual_seed(0))
    z = _rank_normalize(x)
    assert bool(torch.isfinite(z).all()) and float(z.abs().max()) < 5.3


@pytest.mark.parametrize("num_chains", [None, 3])
def test_chains_bundle_matches_jax(num_chains):
    rng = np.random.default_rng(4)
    lead = () if num_chains is None else (num_chains,)
    params = rng.normal(size=lead + (40, 2)).astype(np.float32)
    lp = rng.normal(size=lead + (40,)).astype(np.float32)
    acc = rng.uniform(size=lead + (40,)) < 0.5
    sched = port.Schedule(n_samples=40, discard_initial=10, thinning=2)
    res = SamplingResult(transition_from_numpy(params, lp, acc, device="cpu"), None, sched, num_chains)
    rref = RefResult(RefTransition(jnp.asarray(params), jnp.asarray(lp), jnp.asarray(acc)),
                     None, ref.Schedule(n_samples=40, discard_initial=10, thinning=2),
                     num_chains)
    c = bundle_chains(res, param_names=["μ", "σ"])
    r = ref_bundle_chains(rref, param_names=["μ", "σ"])
    np.testing.assert_array_equal(c.values.numpy(), np.asarray(r.values))
    np.testing.assert_array_equal(c.lp.numpy(), np.asarray(r.lp))
    assert (c.names, c.range, c.internals) == (r.names, r.range, r.internals)
    np.testing.assert_allclose(c.mean().numpy(), np.asarray(r.mean()), rtol=1e-6)
    np.testing.assert_allclose(c.std().numpy(), np.asarray(r.std()), rtol=1e-5)
    np.testing.assert_allclose(c.cov().numpy(), np.asarray(r.cov()), rtol=1e-5, atol=1e-7)
    if num_chains is None:
        return  # the summary's statistics are compared on the batched layout
    cs, rs = c.summary(), r.summary()
    assert list(cs) == list(rs)
    for name in cs:
        assert list(cs[name]) == list(rs[name])
        for k in cs[name]:
            np.testing.assert_allclose(cs[name][k], rs[name][k], rtol=RTOL)


def _params(*draws):
    """(N, P, C) float32 draws, Chains.values' layout, from (N, C) arrays."""
    return np.stack(draws, axis=1).astype(np.float32)


ONE_PASS = {
    "chains": _params(_ar1(256, 3, 0.7, 5), _ar1(256, 3, 0.3, 6, shift=2.0)),
    "odd rows": _params(_ar1(257, 4, 0.5, 7), _ar1(257, 4, 0.9, 8, shift=-1.0)),
    "one chain": _params(_ar1(301, 1, 0.6, 9)),
    "below the window": _params(_ar1(7, 3, 0.4, 10)),
    "past the window": _params(_ar1(4000, 4, 0.995, 11), _ar1(4000, 4, 0.2, 12)),
    "constant": _params(np.full((100, 4), 1.25, np.float32)),
}


@pytest.mark.parametrize("case", sorted(ONE_PASS))
def test_one_pass_summary_matches_jax(case):
    """``Chains.summary()``'s one pass, the card's path for float32 draws
    (here its kernels' plain versions), against the JAX package's summary
    of the same draws: every statistic, in the same order. The slow chains
    of "past the window" take the FFT fallback; constant draws keep ESS's
    floor and R̂'s NaN."""
    from advancedmh_tpu.output.chains import Chains as RefChains
    from advancedmh_tpu_torch.output.chains import Chains

    values = ONE_PASS[case]
    n, p, c = values.shape
    names = [f"p{i}" for i in range(p)]
    got = Chains(torch.as_tensor(values), torch.zeros(n, c), names)._summary_one_pass()
    want = RefChains(jnp.asarray(values), jnp.zeros((n, c)), names).summary()
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name])
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=RTOL)
