"""``Chains.summary()``'s one-pass path (``ops/summary.py``: the chain moments
and the finish) against its per-statistic path, on the CPU.

On the CPU the wrappers run their plain versions, so ``_summary_one_pass``
runs here as it runs on the card, launches aside. It agrees with the
per-statistic path within float32 rounding: that path reduces in float32,
the one pass in float64, and each centres the ESS window on its own float32
chain means (rtol 1e-5 for ESS and mcse, as the window against the FFT).
"""
from __future__ import annotations

import collections
import math

import numpy as np
import pytest
import torch

import advancedmh_tpu_torch as amh
from advancedmh_tpu_torch.diagnostics.ess import (LAG_WINDOW, _autocov, _ess_fft, ess,
                                                  window_sums)
from advancedmh_tpu_torch.ops.autocov import (autocov_window, autocov_window_reference,
                                              geyer_tau, window_rho)
from advancedmh_tpu_torch.ops.summary import (COLUMNS, chain_moments, chain_moments_reference,
                                              range_counts, summary_finish,
                                              summary_finish_reference)
from advancedmh_tpu_torch.output.chains import Chains
from advancedmh_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tests run in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_spans_left():
    trace.clear()
    yield
    trace.clear()


def ar1(phi: float, n: int, c: int, seed: int, loc: float = 0.0) -> torch.Tensor:
    """float32 AR(1) draws (n, c) about ``loc``, each chain started in its
    stationary law."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal((n, c))
    x = np.empty((n, c))
    x[0] = e[0] / np.sqrt(1.0 - phi * phi)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return torch.tensor(x + loc, dtype=torch.float32)


def draws(n: int, p: int, c: int, seed: int) -> torch.Tensor:
    """(n, p, c) draws, parameter i an AR(1) of its own correlation and
    location, laid out as Chains.values."""
    return torch.stack([ar1((0.2, 0.6, 0.85)[i], n, c, seed + i, loc=(0.0, 5.0, -2.0)[i])
                        for i in range(p)], dim=1)


def _chains(values: torch.Tensor) -> Chains:
    n, p, c = values.shape
    return Chains(values, torch.zeros(n, c), [f"p{i}" for i in range(p)])


SHAPES = [(n, p, c) for n in (2, 7, 100, 129, 1001) for p in (1, 2, 3) for c in (1, 3, 64)]


# ---- the moments' plain version -------------------------------------------------------------


@pytest.mark.parametrize("n, p, c", [(1, 1, 1)] + SHAPES)
def test_moments_are_each_ranges_sum_and_centred_second_moment(n, p, c):
    values = draws(n, p, c, seed=n + 10 * c)
    moments, means = chain_moments_reference(values)
    assert moments.shape == (p, 3, 2, c) and moments.dtype == torch.float64
    assert means.shape == (p, c) and means.dtype == torch.float32
    h = n // 2
    x = values.double().permute(1, 0, 2)  # (P, N, C)
    for r, rows in enumerate((x[:, :h], x[:, h:2 * h], x[:, 2 * h:])):
        count = range_counts(n)[r]
        assert rows.shape[1] == count
        if count == 0:
            assert torch.equal(moments[:, r], torch.zeros(p, 2, c, dtype=torch.float64))
            continue
        torch.testing.assert_close(moments[:, r, 0] / count, torch.mean(rows, dim=1),
                                   rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(moments[:, r, 1] / count,
                                   torch.var(rows, dim=1, correction=0), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(means, torch.mean(values, dim=0), rtol=1e-6, atol=1e-6)


def test_moments_of_constant_draws_are_exact():
    values = torch.full((9, 2, 5), 1.5)
    moments, means = chain_moments(values)
    assert torch.equal(moments[:, :, 1], torch.zeros(2, 3, 5, dtype=torch.float64))
    assert torch.equal(moments[:, :2, 0], torch.full((2, 2, 5), 4 * 1.5, dtype=torch.float64))
    assert torch.equal(moments[:, 2, 0], torch.full((2, 5), 1.5, dtype=torch.float64))
    assert torch.equal(means, torch.full((2, 5), 1.5))


# ---- the finish against the per-statistic path ----------------------------------------------


def _assert_agree(got: dict, want: dict) -> None:
    """Each statistic within float32 rounding of the per-statistic path's; NaN where it is NaN."""
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        assert set(g) == set(w) == set(COLUMNS) - {"decided"}
        for stat, rtol in (("std", 2e-6), ("naive_se", 2e-6), ("ess", 1e-5), ("mcse", 1e-5),
                           ("rhat", 2e-6)):
            if math.isnan(w[stat]):
                assert math.isnan(g[stat]), (name, stat)
            else:
                assert abs(g[stat] - w[stat]) <= rtol * abs(w[stat]), (name, stat, g, w)
        assert abs(g["mean"] - w["mean"]) <= 2e-6 * max(w["std"], abs(w["mean"])), (name, g, w)


@pytest.mark.parametrize("n, p, c", SHAPES)
def test_one_pass_agrees_with_the_per_statistic_path(n, p, c):
    chains = _chains(draws(n, p, c, seed=3 * n + c))
    before = ess.fft_fallbacks
    got = chains._summary_one_pass()
    fallbacks = ess.fft_fallbacks - before
    _assert_agree(got, chains.summary())
    assert ess.fft_fallbacks - before == 2 * fallbacks  # the same parameters fall back


@pytest.mark.parametrize("n, p, c", [(7, 1, 1), (100, 2, 3), (129, 3, 64), (1001, 2, 1)])
def test_finish_reference_is_the_table_of_the_per_statistic_path(n, p, c):
    values = draws(n, p, c, seed=n * c)
    moments, means = chain_moments_reference(values)
    acov = torch.stack([autocov_window_reference(values[:, i, :], means[i], LAG_WINDOW)
                        for i in range(p)])
    table = summary_finish_reference(moments, means, acov, n)
    assert table.shape == (p, len(COLUMNS)) and table.dtype == torch.float64
    assert torch.equal(table, summary_finish(moments, means, acov, n))
    want = _chains(values)._summary_per_statistic()
    rows = {f"p{i}": dict(zip(COLUMNS, table[i].tolist())) for i in range(p)}
    assert all(row.pop("decided") == 1.0 for row in rows.values())
    _assert_agree(rows, want)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("n", [100, 1001])
def test_constant_draws_keep_the_floor_and_nan(n, c):
    """Draws constant in every chain: std 0, ESS at τ's floor (the NaN pair
    rule), R̂ NaN (0 over 0), as the per-statistic path gives on the CPU."""
    values = torch.stack([torch.full((n, c), 1.5), torch.full((n, c), 2.0)], dim=1)
    chains = _chains(values)
    got, want = chains._summary_one_pass(), chains.summary()
    for name, value in (("p0", 1.5), ("p1", 2.0)):
        g = got[name]
        assert g["mean"] == value and g["std"] == 0.0 and g["mcse"] == 0.0
        assert g["ess"] == want[name]["ess"] == n * c / 1e-6
        assert math.isnan(g["rhat"]) and math.isnan(want[name]["rhat"])


# ---- reads, spans and the FFT fallback ------------------------------------------------------


def test_one_pass_reads_once_in_its_three_spans():
    chains = _chains(draws(1001, 2, 8, seed=5))
    before = trace.host_syncs()
    with amh.tracing():
        chains._summary_one_pass()
    assert trace.host_syncs() - before == collections.Counter(summary=1)
    spans = trace.recorded()
    assert [s.name for s in spans if s.parent is None] == [
        "summary.moments", "summary.ess", "summary.read"]
    kids = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[spans[s.parent].name].append(s.name)
    assert kids == {"summary.moments": ["kernel.chain_moments"],
                    "summary.ess": ["kernel.summary_finish"],
                    "summary.read": ["sync.summary"]}


def test_a_parameter_past_the_window_takes_the_fft_and_one_more_read():
    slow, fast = ar1(0.995, 4000, 4, seed=7), ar1(0.2, 4000, 4, seed=8)
    chains = _chains(torch.stack([slow, fast], dim=1))
    before, syncs = ess.fft_fallbacks, trace.host_syncs()
    with amh.tracing():
        got = chains._summary_one_pass()
    assert ess.fft_fallbacks == before + 1
    assert trace.host_syncs() - syncs == collections.Counter(summary=2)
    assert got["p0"]["ess"] == float(_ess_fft(slow))
    assert got["p0"]["mcse"] == got["p0"]["std"] / math.sqrt(got["p0"]["ess"])
    spans = trace.recorded()
    fallback = next(i for i, s in enumerate(spans) if s.name == "ess.fft_fallback")
    assert spans[spans[fallback].parent].name == "summary.ess"
    assert [s.name for s in spans if s.parent == fallback] == ["sync.summary"]
    _assert_agree(got, chains.summary())


# ---- the wrappers ---------------------------------------------------------------------------


def test_window_sums_are_each_parameters_window():
    values = draws(300, 3, 5, seed=11)
    _, means = chain_moments(values)
    got = window_sums(values, means)
    assert got.shape == (3, LAG_WINDOW) and got.dtype == torch.float64
    for i in range(3):
        assert torch.equal(got[i], autocov_window_reference(values[:, i, :], means[i],
                                                            LAG_WINDOW))
    assert window_sums(values[:50], means).shape == (3, 50)


GEYER = {
    # rho, n: the sums 1.5, 0.5, -0.25 (running min), past the window none
    "cut inside the window": ([1.0, 0.5, 0.3, 0.2, -0.1, -0.15], 100, 2 * (1.5 + 0.5) - 1, True),
    "runs past the window": ([1.0, 0.8, 0.7, 0.6], 100, 2 * (1.8 + 1.3) - 1, False),
    "the window holds every pair": ([1.0, 0.8, 0.7, 0.6, 0.5], 5, 2 * (1.8 + 1.3) - 1, True),
    "NaN pairs count as 0": ([float("nan")] * 4, 100, 1e-6, True),
}


@pytest.mark.parametrize("case", sorted(GEYER))
def test_geyer_tau_is_the_paired_sums_and_decides_by_the_last_pair(case):
    """``ops/autocov.py::geyer_tau``, the one statement of the window's rule
    in Python: τ = 2 Σ max(running min of the pair sums, 0) − 1, floored at
    1e-6, decided where the last pair's running min is not positive or the
    lags hold every pair."""
    rho, n, tau, decided = GEYER[case]
    got, got_decided = geyer_tau(torch.tensor(rho, dtype=torch.float64), n)
    assert float(got) == pytest.approx(tau, rel=1e-15, abs=0.0)
    assert bool(got_decided) is decided


@pytest.mark.parametrize("c", [1, 6])
def test_window_rho_is_the_fft_paths_rho_at_the_windows_lags(c):
    """``ops/autocov.py::window_rho`` on the window's sums gives, at each of
    its lags, the autocorrelation the FFT path forms from all N lags (the
    chain means' variance only where C > 1)."""
    n = 500
    x = ar1(0.7, n, c, seed=3 + c)
    means = torch.mean(x, dim=0)
    got = window_rho(autocov_window_reference(x, means, LAG_WINDOW), means, n)
    acov = _autocov(x.double())
    mean_var = torch.mean(acov[0]) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + torch.var(torch.mean(x.double(), dim=0), correction=1)
    want = 1.0 - (mean_var - torch.mean(acov, dim=1)) / var_plus
    assert got.shape == (LAG_WINDOW,)
    torch.testing.assert_close(got, want[:LAG_WINDOW], rtol=0.0, atol=1e-5)


def test_the_window_writes_into_out_or_refuses_it():
    x, m = ar1(0.5, 40, 3, seed=1), torch.zeros(3)
    out = torch.zeros(2, 16, dtype=torch.float64)
    assert autocov_window(x, m, 16, out=out[1]) is not None
    assert torch.equal(out[1], autocov_window_reference(x, m, 16)) and not out[0].any()
    for bad in (torch.zeros(15, dtype=torch.float64), torch.zeros(16),
                torch.zeros(16, 2, dtype=torch.float64)[:, 0]):
        with pytest.raises(ValueError, match="out must be"):
            autocov_window(x, m, 16, out=bad)


def test_wrappers_on_cpu_launch_nothing():
    from advancedmh_tpu_torch.ops import _build

    before = (chain_moments.launches, summary_finish.launches)
    _chains(draws(100, 2, 4, seed=2)).summary()
    _chains(draws(100, 2, 4, seed=2))._summary_one_pass()
    assert (chain_moments.launches, summary_finish.launches) == before
    assert _build.library.cache_info().currsize == 0


@pytest.mark.parametrize("bad", ["dtype", "ndim", "empty"])
def test_moments_refuse_what_the_kernel_does_not_take(bad):
    values = {"dtype": torch.zeros(10, 2, 3, dtype=torch.float64), "ndim": torch.zeros(10, 3),
              "empty": torch.zeros(0, 2, 3)}[bad]
    with pytest.raises(ValueError):
        chain_moments(values)


@pytest.mark.parametrize("bad", ["moments", "means", "acov_rows", "acov_lags", "acov_dtype"])
def test_finish_refuses_what_the_kernel_does_not_take(bad):
    n, p, c = 20, 2, 3
    moments, means, acov = (torch.zeros(p, 3, 2, c, dtype=torch.float64), torch.zeros(p, c),
                            torch.zeros(p, 16, dtype=torch.float64))
    if bad == "moments":
        moments = torch.zeros(p, 3, 2, c + 1, dtype=torch.float64)
    elif bad == "means":
        means = means.double()
    elif bad == "acov_rows":
        acov = torch.zeros(p + 1, 16, dtype=torch.float64)
    elif bad == "acov_lags":
        acov = torch.zeros(p, n + 1, dtype=torch.float64)
    else:
        acov = acov.float()
    with pytest.raises(ValueError):
        summary_finish(moments, means, acov, n)
