"""Spans and host-sync counts: where a call's host time goes.

Spans. ``span(name)`` records one interval of host time: its name, its start
and end on the host clock ``time.perf_counter_ns()``, the index in
``recorded()`` of the innermost span open on the same thread when it began
(None for a root), and a call id, which a root span draws anew and its
descendants inherit. Spans record while a torch profiler captures
(``torch.autograd.profiler._is_profiler_enabled``) or inside ``tracing()``.
Otherwise ``span()`` returns one shared no-op context: it reads no clock,
enters no ``record_function`` and allocates nothing. While a profiler
captures, each span is also a ``torch.profiler.record_function("amh.<name>")``,
so the profiler's trace shows every device operation, and every gap in
which the device is idle, under the span the host was in. A span never
synchronizes and never reads a tensor.

The program's spans:

- ``sample``: the public ``sample()`` call;
- ``fused.start``: the fused engine's (d, C) start block and its initial lp;
- ``fused.prepare``: a sampler's arguments before the launch (the proposal
  scale and its copy to the device);
- ``kernel.<name>``: a kernel wrapper of ``ops/`` (argument checks and
  packing, output allocation, the launch or, on the CPU, the plain version),
  named by its key in ``ops.KERNEL_WRAPPERS``;
- ``fused.layout``: the kernel's outputs as transitions;
- ``bundle``: ``SamplingResult.to_chains()``;
- ``summary`` and, on the card (float32 draws, contiguous chains), its one
  pass: ``summary.moments`` (the chain-moments launch), ``summary.ess`` (a
  lag-window launch a parameter and the finish) and ``summary.read`` (the
  one host read); elsewhere, for each statistic of each parameter with its
  host read, ``summary.mean``, ``summary.std``, ``summary.mcse``,
  ``summary.ess``, ``summary.rhat``;
- ``ess.fft_fallback``: the FFT ESS that runs where the lag window did not
  decide Geyer's sequence (``diagnostics/ess.py``), with its host read
  inside ``summary()``;
- ``sync.<site>``: a host sync, below.

Host syncs. The host reads device data (``float()``, ``int()``,
``Tensor.item``, ``.cpu``, ``.numpy``, ``.tolist``) and copies pageable host
memory to the device through ``host_sync(site, fn, ...)``, which counts each
one by site in an always-on counter (``host_syncs()``) and, while spans
record, records the wait as the span ``sync.<site>``. On a CUDA device each
such read waits for the stream; on the CPU it is only a read, and counts
all the same.

The process has one recorder, ``RECORDER``: spans are kept in memory until
``clear()``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

PREFIX = "amh."


class Span:
    """One recorded span. ``end_ns`` is None while the span is open;
    ``parent`` is the index in ``recorded()`` of the span it opened in."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call")

    def __init__(self, name: str, parent: Optional[int], call: int):
        self.name = name
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self.parent = parent
        self.call = call

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, start_ns={self.start_ns}, end_ns={self.end_ns}, "
                f"parent={self.parent}, call={self.call})")


class Recorder:
    """The spans recorded so far, the host syncs counted by site, and the
    number of open ``tracing()`` blocks."""

    def __init__(self):
        self.spans: List[Span] = []
        self.syncs: collections.Counter = collections.Counter()
        self.depth = 0
        self.lock = threading.Lock()
        self._local = threading.local()
        self._calls = itertools.count()

    def open_stack(self) -> list:
        """This thread's open spans, innermost last, as (index, call id)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


RECORDER = Recorder()


class _SpanContext:
    """The context of one recording span."""

    __slots__ = ("_name", "_span", "_rf")

    def __init__(self, name: str):
        self._name = name

    def __enter__(self):
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(PREFIX + self._name)
            self._rf.__enter__()
        stack = RECORDER.open_stack()
        parent, call = stack[-1] if stack else (None, next(RECORDER._calls))
        span = Span(self._name, parent, call)
        with RECORDER.lock:
            index = len(RECORDER.spans)
            RECORDER.spans.append(span)
        stack.append((index, call))
        self._span = span
        span.start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc):
        self._span.end_ns = time.perf_counter_ns()
        RECORDER.open_stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records the span ``name`` while spans record, else
    the shared no-op ``NO_SPAN``."""
    if not (RECORDER.depth or _profiler._is_profiler_enabled):
        return NO_SPAN
    return _SpanContext(name)


def traced(name: str) -> Callable:
    """Decorate a function so that each call is the span ``name``
    (``<function>.span_name``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not (RECORDER.depth or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _SpanContext(name):
                return fn(*args, **kwargs)

        inner.span_name = name
        return inner

    return wrap


def host_sync(site: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``, a host read of device data or a blocking copy
    to the device, counted at ``site`` and spanned as ``sync.<site>``."""
    with RECORDER.lock:
        RECORDER.syncs[site] += 1
    if not (RECORDER.depth or _profiler._is_profiler_enabled):
        return fn(*args, **kwargs)
    with _SpanContext("sync." + site):
        return fn(*args, **kwargs)


@contextlib.contextmanager
def tracing() -> Iterator[Recorder]:
    """Record spans inside the block, on the host clock alone unless a
    profiler also captures; yields the recorder."""
    with RECORDER.lock:
        RECORDER.depth += 1
    try:
        yield RECORDER
    finally:
        with RECORDER.lock:
            RECORDER.depth -= 1


def recorded() -> List[Span]:
    """The spans recorded since the last ``clear()``, in order of start."""
    with RECORDER.lock:
        return list(RECORDER.spans)


def clear() -> None:
    """Drop the recorded spans (call it with no span open)."""
    with RECORDER.lock:
        RECORDER.spans.clear()


def host_syncs() -> collections.Counter:
    """The host syncs counted so far, by site (a copy)."""
    with RECORDER.lock:
        return collections.Counter(RECORDER.syncs)
