"""Arithmetic the per-layer readers share (``metrics/<name>.py``).

A reader is ``read(ctx) -> float | None``: ``ctx`` holds the cell, the
measured window (untraced runs), the set-up seconds and, in a traced run,
the parsed trace and each traced call's launches with the bytes and float32
operations each needs. A reader that finds nothing to read returns None and
the metric is left out of the result line.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from portbench.bounds import PEAK_F32_PER_S, bound_seconds


def _traced_calls(ctx):
    """(trace span, call record, launches) of each traced call."""
    if ctx.trace is None:
        return []
    spans = ctx.trace.spans_named("call")
    if len(spans) != len(ctx.calls):  # a call failed inside its span: no pairing
        return []
    return [(s, c["record"], c["info"]["launches"]) for s, c in zip(spans, ctx.calls)]


def kernel_roofline(ctx, kernel: str) -> Optional[float]:
    """The bound of ``kernel``'s launches (the larger of bytes over the
    bandwidth and operations over the float32 rate) over its traced device
    time, in %, from the calls whose launches of it are all known."""
    bound_s = device_us = 0.0
    for span, _, launches in _traced_calls(ctx):
        mine = [l for l in launches if l[0] == kernel]
        if not mine or any(l[1] is None for l in mine):
            continue
        t = ctx.trace.busy_us(span.start, span.end, lambda n: n == kernel)
        if t > 0.0:
            bound_s += sum(bound_seconds(l[1], l[2]) for l in mine)
            device_us += t
    return None if device_us == 0.0 else 100.0 * bound_s / (device_us * 1e-6)


def mfu(ctx) -> Optional[float]:
    """Float32 operations of the traced calls' launches over their wall time
    and the card's float32 rate, in %, from the calls whose launches are all
    known."""
    flops = seconds = 0.0
    for span, _, launches in _traced_calls(ctx):
        if not launches or any(l[1] is None for l in launches):
            continue
        flops += sum(l[2] for l in launches)
        seconds += (span.end - span.start) * 1e-6
    return None if seconds == 0.0 else 100.0 * flops / (seconds * PEAK_F32_PER_S)


def host_share(ctx, span_name: str, keep: Callable[[str], bool]) -> Optional[float]:
    """The share of the spans ``span_name`` in which no device operation
    that ``keep`` keeps runs, in %."""
    if ctx.trace is None:
        return None
    spans: List = ctx.trace.spans_named(span_name)
    total = sum(s.end - s.start for s in spans)
    if total <= 0.0:
        return None
    idle = sum((s.end - s.start) - ctx.trace.busy_us(s.start, s.end, keep) for s in spans)
    return 100.0 * idle / total


def span_share(ctx, part: str) -> Optional[float]:
    """The share of the traced calls' time spent in the benchmark's span
    ``part``, by the host clock, in %."""
    calls = [c["record"] for c in ctx.calls]
    total = sum(r.seconds for r in calls)
    inside = sum(r.spans.get(part, 0.0) for r in calls)
    return None if total <= 0.0 or inside <= 0.0 else 100.0 * inside / total


def is_port_kernel(name: str) -> bool:
    return name.startswith("amh::")
