"""ESS from the lag window (``diagnostics/ess.py::_ess_window``, the sums of
``ops/autocov.py``) against the FFT path (``_ess_fft``), on the CPU.

Where the window decides Geyer's sequence its ESS equals the FFT's within
float32 rounding (rtol 1e-5: the FFT's own rounding, ~1e-6 of the lag-0 sum
an autocorrelation, is the larger error). Where the sequence runs past the
window, ``ess`` and ``summary()`` return the FFT's ESS bit for bit, count
the fallback in ``ess.fft_fallbacks`` and read the device once more.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import advancedmh_tpu_torch as amh
from advancedmh_tpu_torch.diagnostics.ess import (LAG_WINDOW, _ess_fft, _ess_window, _quantile,
                                                  ess, ess_tail)
from advancedmh_tpu_torch.ops.autocov import (MAX_LAGS, autocov_window,
                                              autocov_window_reference)
from advancedmh_tpu_torch.output.chains import Chains
from advancedmh_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's threads in each would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_spans_left():
    trace.clear()
    yield
    trace.clear()


def ar1(phi: float, n: int, c: int, seed: int) -> torch.Tensor:
    """float32 AR(1) draws (n, c), each chain started in its stationary law."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, c))
    x = np.empty((n, c))
    x[0] = e[0] / np.sqrt(1.0 - phi * phi)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return torch.tensor(x, dtype=torch.float32)


def _close(got, want, rtol=1e-5):
    return abs(float(got) - float(want)) <= rtol * abs(float(want))


# ---- the window against the FFT -------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 4, 64])
@pytest.mark.parametrize("n", [100, 129, 255, 256, 1000])
@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_window_and_ess_equal_the_fft(phi, n, c):
    x = ar1(phi, n, c, seed=1000 * n + c + int(10 * phi))
    want = _ess_fft(x)
    got, decided = _ess_window(x)
    assert got.dtype == torch.float32 and decided.dtype == torch.bool
    if n <= LAG_WINDOW + 1 or phi < 0.9:  # the window holds every pair, or τ is short
        assert bool(decided)
    if bool(decided):
        assert _close(got, want)
    before = ess.fft_fallbacks
    assert _close(ess(x), want)
    assert ess.fft_fallbacks == before + (not bool(decided))


def test_window_reads_a_strided_view_as_its_copy():
    x = ar1(0.5, 600, 8, seed=3)
    view = x.T.contiguous().T  # chains strided by 600
    assert view.stride(1) != 1
    assert torch.equal(_ess_window(view)[0], _ess_window(x.contiguous())[0])


@pytest.mark.parametrize("n", [100, 1000])
def test_constant_draws_take_the_floor_through_the_same_nan_rule(n):
    x = torch.full((n, 4), 1.5)
    got, decided = _ess_window(x)
    before = ess.fft_fallbacks
    assert float(_ess_fft(x)) == float(got) == n * 4 / 1e-6
    assert bool(decided)  # NaN pair sums: the running min stays NaN past the window
    assert float(ess(x)) == n * 4 / 1e-6 and ess.fft_fallbacks == before


def test_running_min_propagates_nan_as_the_window_assumes():
    pair_sums = torch.tensor([1.5, float("nan"), 0.7, 0.2], dtype=torch.float64)
    assert torch.isnan(torch.cummin(pair_sums, dim=0).values[1:]).all()


def test_a_nan_draw_gives_the_ffts_floor():
    x = ar1(0.5, 1000, 4, seed=5)
    x[17, 2] = float("nan")
    got, decided = _ess_window(x)
    assert bool(decided) and float(got) == float(_ess_fft(x)) == 4000 / 1e-6


def test_chains_constant_apart_never_truncate_and_fall_back():
    x = torch.arange(4, dtype=torch.float32).repeat(1000, 1) * 0.5
    assert not bool(_ess_window(x)[1])  # ρ = 1 at every lag
    before = ess.fft_fallbacks
    assert torch.equal(ess(x), _ess_fft(x)) and ess.fft_fallbacks == before + 1


def test_tail_indicator_draws():
    x = ar1(0.7, 2000, 16, seed=11)
    lo, hi = np.quantile(x.numpy(), [0.05, 0.95])
    for ind in ((x <= float(lo)).to(torch.float32), (x >= float(hi)).to(torch.float32)):
        got, decided = _ess_window(ind)
        assert bool(decided) and _close(got, _ess_fft(ind))
    got = ess_tail(x)
    lo_t, hi_t = _quantile(x, 0.05), _quantile(x, 0.95)
    want = torch.minimum(_ess_fft((x <= lo_t).to(torch.float32)),
                         _ess_fft((x >= hi_t).to(torch.float32)))
    assert _close(got, want)


def test_a_sequence_past_the_window_takes_the_fft_bit_for_bit():
    x = ar1(0.995, 4000, 4, seed=7)
    assert not bool(_ess_window(x)[1])
    before, syncs = ess.fft_fallbacks, trace.host_syncs()
    with amh.tracing():
        got = ess(x)
    assert torch.equal(got, _ess_fft(x))
    assert ess.fft_fallbacks == before + 1
    assert trace.host_syncs() - syncs == collections.Counter(ess=1)
    assert [s.name for s in trace.recorded()] == ["sync.ess", "ess.fft_fallback"]


def test_float64_draws_keep_the_fft():
    x = ar1(0.5, 500, 4, seed=2).double()
    before = trace.host_syncs()
    assert torch.equal(ess(x), _ess_fft(x))
    assert trace.host_syncs() == before


# ---- summary() ------------------------------------------------------------------------------


def _chains(*params: torch.Tensor) -> Chains:
    values = torch.stack(params, dim=1)  # (N, P, C)
    lp = torch.zeros(values.shape[0], values.shape[2])
    return Chains(values, lp, [f"p{i}" for i in range(len(params))])


def test_summary_mcse_is_std_over_root_ess_of_the_same_call():
    chains = _chains(ar1(0.5, 800, 32, seed=1), ar1(0.8, 800, 32, seed=2))
    for name, s in chains.summary().items():
        f32 = dict(dtype=torch.float32)
        want = torch.tensor(s["std"], **f32) / torch.sqrt(torch.tensor(s["ess"], **f32))
        assert s["mcse"] == float(want)
        assert s["ess"] == float(ess(chains[name]))


def test_a_fallback_inside_summary_adds_one_read():
    slow, fast = ar1(0.995, 4000, 4, seed=7), ar1(0.2, 4000, 4, seed=8)
    chains = _chains(slow, fast)
    before, syncs = ess.fft_fallbacks, trace.host_syncs()
    with amh.tracing():
        out = chains.summary()
    assert ess.fft_fallbacks == before + 1
    assert trace.host_syncs() - syncs == collections.Counter(summary=5 * 2 + 1)
    assert out["p0"]["ess"] == float(_ess_fft(slow))
    spans = trace.recorded()
    kids = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append(s.name)
    ess_spans = [i for i, s in enumerate(spans) if s.name == "summary.ess"]
    assert [kids[i] for i in ess_spans] == [["sync.summary", "ess.fft_fallback"],
                                            ["sync.summary"]]
    fallback = next(i for i, s in enumerate(spans) if s.name == "ess.fft_fallback")
    assert kids[fallback] == ["sync.summary"]


# ---- the sums and their wrapper -------------------------------------------------------------


@pytest.mark.parametrize("n, c, K", [(7, 3, 128), (300, 5, 128), (1000, 33, 16)])
def test_window_sums_are_the_centred_lag_products(n, c, K):
    x = ar1(0.6, n, c, seed=n + c)
    m = torch.mean(x, dim=0)
    got = autocov_window(x, m, K)
    y = x.double().numpy() - m.double().numpy()
    want = [float(np.sum(y[: n - k] * y[k:])) for k in range(min(K, n))]
    assert got.dtype == torch.float64 and got.shape == (min(K, n),)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * want[0])
    assert torch.equal(got, autocov_window_reference(x, m, K))


def test_window_on_cpu_launches_nothing():
    from advancedmh_tpu_torch.ops import _build

    before = autocov_window.launches
    ess(ar1(0.3, 500, 8, seed=4))
    assert autocov_window.launches == before
    assert _build.library.cache_info().currsize == 0


@pytest.mark.parametrize("bad", ["dtype", "means", "K0", "Kbig", "empty"])
def test_window_refuses_what_the_kernel_does_not_take(bad):
    x, m, K = torch.zeros(10, 3), torch.zeros(3), 8
    if bad == "dtype":
        x = x.double()
    elif bad == "means":
        m = torch.zeros(4)
    elif bad == "K0":
        K = 0
    elif bad == "Kbig":
        K = MAX_LAGS + 1
    else:
        x = torch.zeros(0, 3)
    with pytest.raises(ValueError):
        autocov_window(x, m, K)
