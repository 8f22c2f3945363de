"""The program's own spans (``advancedmh_tpu_torch.utils.trace``), by traced
call, for the per-layer readers that read them.

While the profiler captures the traced window, the program records its spans
on the host clock ``time.perf_counter_ns()``; the warm-up ran before the
profiler started and recorded none. Each span is assigned to the traced call
whose host interval (``CallRecord.start`` and ``end``, ``time.perf_counter``,
the same clock) holds it. A program without the tracing module, or a run in
which it recorded nothing, gives nothing.
"""
from __future__ import annotations

import importlib
from typing import List, Tuple


def spans_by_call(ctx) -> List[Tuple[object, list]]:
    """(call record, the program's spans inside it) of each traced call, or
    [] when the program recorded none in them."""
    try:
        trace = importlib.import_module("advancedmh_tpu_torch.utils.trace")
    except ImportError:
        return []
    spans = [s for s in trace.recorded() if s.end_ns is not None]
    out = []
    for call in ctx.calls:
        rec = call["record"]
        lo, hi = rec.start * 1e9, rec.end * 1e9
        out.append((rec, [s for s in spans if lo <= s.start_ns and s.end_ns <= hi]))
    return out if any(inside for _, inside in out) else []


def duration_ns(span) -> int:
    return span.end_ns - span.start_ns
