"""Reading a ``torch.profiler`` trace of the traced window.

The trace is exported as Chrome trace JSON (into the run's temporary
directory, deleted once read) and reduced to what the per-layer readers
and the breakdown need: the device's operations (kernels, copies, sets) as
intervals, the benchmark's own spans (``record_function("portbench.<name>")``)
and the host's operations, all on the trace's one clock (microseconds).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
from typing import Callable, Iterable, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_PREFIX = "portbench."

Interval = Tuple[float, float]


def kernel_name(raw: str) -> str:
    """``void amh::rwmh_sample_kernel<amh::X, false>(float const*, ...)`` →
    ``amh::rwmh_sample_kernel``: the qualified name without the return type,
    template arguments and parameters."""
    name = raw[5:] if raw.startswith("void ") else raw
    name = name.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or raw


@dataclasses.dataclass
class Event:
    name: str
    start: float
    end: float


@dataclasses.dataclass
class Trace:
    device: List[Event]  # sorted by start
    spans: List[Event]  # the benchmark's spans, "portbench." stripped
    host: List[Event]  # the host's operations

    def spans_named(self, name: str) -> List[Event]:
        return [s for s in self.spans if s.name == name]

    def window(self) -> Interval:
        calls = self.spans_named("call")
        return calls[0].start, calls[-1].end

    def busy_us(self, lo: float, hi: float,
                keep: Optional[Callable[[str], bool]] = None) -> float:
        """Microseconds of [lo, hi] in which some device operation (that
        ``keep`` keeps) runs."""
        return sum(b - a for a, b in merged(
            (max(e.start, lo), min(e.end, hi)) for e in self.device
            if (keep is None or keep(e.name)) and e.end > lo and e.start < hi))

    def gaps(self, lo: float, hi: float) -> List[Interval]:
        """The intervals of [lo, hi] in which no device operation runs."""
        out, t = [], lo
        for a, b in merged((max(e.start, lo), min(e.end, hi)) for e in self.device
                           if e.end > lo and e.start < hi):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def host_label(self, t: float) -> str:
        """What the host was doing at t: the innermost benchmark span and the
        innermost host operation around it."""
        span = _innermost(self.spans, t)
        op = _innermost(self.host, t)
        return f"{span.name if span else '-'}:{op.name if op else '-'}"


def _innermost(events: List[Event], t: float) -> Optional[Event]:
    best = None
    for e in events:
        if e.start <= t <= e.end and (best is None or e.start >= best.start):
            best = e
    return best


def merged(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def parse(events: list) -> Trace:
    device, spans, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            device.append(Event(kernel_name(name) if cat == "kernel" else name, start, end))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append(Event(name[len(SPAN_PREFIX):], start, end))
        elif cat == "cpu_op":
            host.append(Event(name, start, end))
    for lst in (device, spans, host):
        lst.sort(key=lambda ev: ev.start)
    return Trace(device, spans, host)


def read_profile(prof) -> Trace:
    """Export ``prof`` to a temporary Chrome trace, read it and delete it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    by what the host was doing, in seconds."""
    lo, hi = trace.window()
    by_name = {}
    for e in trace.device:
        if e.end > lo and e.start < hi:
            by_name[e.name] = by_name.get(e.name, 0.0) + (min(e.end, hi) - max(e.start, lo))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, us * 1e-6] for n, us in ops],
            "idle_gaps": [[trace.host_label(0.5 * (a + b)), (b - a) * 1e-6] for a, b in gaps]}
