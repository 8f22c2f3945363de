"""The port's spans and host-sync counter (``advancedmh_tpu_torch/utils/trace.py``).

CPU tests: with spans off a flagship call records nothing, reads no clock
and enters no ``record_function``; inside ``tracing()`` it records the span
tree of the front end, the fused dispatch, the kernel wrapper, ``to_chains()``
and each ``summary()`` statistic; under ``torch.profiler`` every span is an
``amh.<name>`` annotation of the profiler's trace; the counter counts each
host read at its site. The tests marked ``cuda`` run on the card
(``python -m pytest --noconftest tests/test_torch_trace.py``): there every
synchronizing operation of a flagship call is counted, and turning tracing
on adds no sync and changes no bit.
"""
from __future__ import annotations

import collections
import contextlib
import json
import sys
import threading
import tracemalloc
import warnings

import pytest
import torch

import advancedmh_tpu_torch as amh
from advancedmh_tpu_torch.models import gaussian_mean_scale_model
from advancedmh_tpu_torch.ops import KERNEL_WRAPPERS
from advancedmh_tpu_torch.utils import trace

D = 2  # the flagship's (mu, sigma)
STATISTICS = {"summary.mean", "summary.std", "summary.mcse", "summary.ess", "summary.rhat"}


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


def _flagship(device, n_chains=64, n_samples=40, discard=20):
    model = gaussian_mean_scale_model(device=device)
    sampler = amh.RWMH(amh.MvNormal(torch.zeros(2, device=device), scale=0.35))
    init = torch.tensor([0.0, 1.0], device=device)

    def call(key, initial=init):
        result = amh.sample(model, sampler, n_samples, key=key, num_chains=n_chains,
                            engine="fused", discard_initial=discard, initial_params=initial)
        return result, result.to_chains().summary()

    return call


def _children(spans, index):
    return [s for s in spans if s.parent == index]


# ---- spans off --------------------------------------------------------------------------


class _NoClock:
    @staticmethod
    def perf_counter_ns():
        raise AssertionError("a span read the clock while spans were off")


def test_spans_off_record_nothing_read_no_clock_and_enter_no_record_function(monkeypatch):
    def no_record_function(*args, **kwargs):
        raise AssertionError("record_function entered while spans were off")

    monkeypatch.setattr(trace, "time", _NoClock)
    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    _flagship("cpu")(7)
    assert trace.recorded() == []
    assert trace.span("sample") is trace.NO_SPAN
    assert trace.span("summary.ess") is trace.NO_SPAN


def test_a_span_that_is_off_allocates_nothing():
    tracemalloc.start()
    try:
        for _ in range(1000):
            with trace.span("summary.ess"):
                pass
        snapshot = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert len(snapshot.filter_traces([tracemalloc.Filter(True, trace.__file__)]).traces) == 0


# ---- spans on ---------------------------------------------------------------------------


def test_tracing_records_the_span_tree_of_a_flagship_call():
    with amh.tracing() as recorder:
        assert recorder is trace.RECORDER
        _flagship("cpu")(7)
    spans = trace.recorded()
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["sample", "bundle", "summary"]
    assert len({spans[i].call for i in roots}) == 3
    sample, _, summary = roots
    assert [s.name for s in _children(spans, sample)] == [
        "fused.start", "fused.prepare", "kernel.rwmh_sample", "fused.layout"]
    prepare = next(i for i in range(len(spans)) if spans[i].name == "fused.prepare")
    assert [s.name for s in _children(spans, prepare)] == ["sync.proposal", "sync.scale"]
    stats = [i for i in range(len(spans)) if spans[i].parent == summary]
    assert len(stats) == 5 * D and {spans[i].name for i in stats} == STATISTICS
    for i in stats:
        assert [s.name for s in _children(spans, i)] == ["sync.summary"]
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            assert s.call == parent.call


def test_tracing_changes_no_output():
    call = _flagship("cpu")
    off, off_summary = call(11)
    with amh.tracing():
        on, on_summary = call(11)
    for name in ("params", "lp", "accepted"):
        assert torch.equal(getattr(off.transitions, name), getattr(on.transitions, name))
    assert off_summary == on_summary


def test_spans_nest_only_within_their_thread():
    def other():
        with trace.span("other"):
            pass

    with amh.tracing():
        with trace.span("outer"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    spans = trace.recorded()
    other_span = next(s for s in spans if s.name == "other")
    outer_span = next(s for s in spans if s.name == "outer")
    assert other_span.parent is None and other_span.call != outer_span.call


def test_each_kernel_wrapper_is_its_own_span():
    assert len(KERNEL_WRAPPERS) == 25
    for name, wrapper in KERNEL_WRAPPERS.items():
        assert wrapper.span_name == f"kernel.{name}"
        assert isinstance(wrapper.launches, int)


def test_every_span_is_an_annotation_of_the_profilers_trace(tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        _flagship("cpu")(5)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(trace.PREFIX)),
                   key=lambda e: (e["ts"], -e["dur"]))
    spans = trace.recorded()
    assert [e["name"] for e in notes] == [trace.PREFIX + s.name for s in spans]
    for note, s in zip(notes, spans):
        if s.parent is not None:
            outer = notes[s.parent]
            assert outer["ts"] <= note["ts"]
            assert note["ts"] + note["dur"] <= outer["ts"] + outer["dur"]


# ---- the host-sync counter -----------------------------------------------------------------


def test_summary_counts_five_reads_a_parameter():
    result, _ = _flagship("cpu")(3)
    chains = result.to_chains()
    before = trace.host_syncs()
    chains.summary()
    assert trace.host_syncs() - before == collections.Counter(summary=5 * D)


@pytest.mark.parametrize("initial, sites", [
    (None, {"proposal": 1, "scale": 1}),
    ([0.0, 1.0], {"initial": 1, "proposal": 1, "scale": 1}),
])
def test_the_front_end_counts_its_fixed_reads(initial, sites):
    call = _flagship("cpu")
    before = trace.host_syncs()
    if initial is None:
        call(3)
    else:
        call(3, initial=initial)
    assert trace.host_syncs() - before == collections.Counter(summary=5 * D, **sites)


def test_the_counter_loses_no_count_across_threads():
    n_threads, n_reads = 16, 500
    before = trace.host_syncs()["stress"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [trace.host_sync("stress", int, 1)
                                                    for _ in range(n_reads)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.host_syncs()["stress"] - before == n_threads * n_reads


# ---- on the card ------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the fused engine's kernels run only there")
    return torch.device("cuda", 0)


def _main_path():
    return _flagship("cuda", n_chains=16384, n_samples=4000, discard=500)


@pytest.mark.cuda
def test_on_the_card_every_sync_of_a_flagship_call_is_counted(card):
    call = _main_path()
    call(1)  # the kernels' build or load and the FFT plans
    torch.cuda.synchronize()
    runs = {}
    for on in (False, True):
        before = trace.host_syncs()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with amh.tracing() if on else contextlib.nullcontext():
                    result, summary = call(2)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        counted = sum((trace.host_syncs() - before).values())
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]
        print(f"tracing {'on' if on else 'off'}: {len(syncs)} synchronizing operations, "
              f"{counted} counted", *syncs, sep="\n  ")
        assert len(syncs) == counted, syncs
        runs[on] = (counted, result.transitions, summary)
    # summary()'s one read on the card (its one-pass path), the proposal's and the scale's
    assert runs[False][0] == runs[True][0] == 1 + 2
    for name in ("params", "lp", "accepted"):
        assert torch.equal(getattr(runs[False][1], name), getattr(runs[True][1], name))
    assert runs[False][2] == runs[True][2]


@pytest.mark.cuda
def test_on_the_card_the_kernel_runs_under_its_annotation(card, tmp_path):
    call = _main_path()
    call(1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call(3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    def note(name):
        return sorted((e for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") == trace.PREFIX + name), key=lambda e: e["ts"])

    kernels = [e for e in events if e.get("cat") == "kernel"
               and "rwmh_sample_kernel" in e.get("name", "")]
    assert len(kernels) == 1
    start, end = kernels[0]["ts"], kernels[0]["ts"] + kernels[0]["dur"]
    (launch,), (sample,) = note("kernel.rwmh_sample"), note("sample")
    first_read = note("sync.summary")[0]
    print(f"annotation amh.sample at {sample['ts']}, amh.kernel.rwmh_sample at {launch['ts']}, "
          f"kernel {start}-{end}, first summary read ends {first_read['ts'] + first_read['dur']}")
    assert sample["ts"] <= launch["ts"] < start
    assert launch["ts"] + launch["dur"] <= sample["ts"] + sample["dur"]
    assert end <= first_read["ts"] + first_read["dur"]
