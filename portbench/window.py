"""The measured window: one closed loop of calls, and the arithmetic on it.

Calls run back to back, as one user's batch job runs them. The window
starts when the first call starts and ends when the last call that started
before ``seconds`` had elapsed has finished; every rate divides by that
measured time, not by the nominal seconds, so a call that straddles the
deadline neither counts whole in a shorter window nor drops out of a longer
one. Between calls the loop records the time and the floats the call
returned, and nothing else.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class CallRecord:
    start: float
    end: float
    units: Dict[str, float]  # what the call completed, e.g. {"ess": 1.2e6}
    spans: Dict[str, float]  # seconds of the benchmark's spans inside the call

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Window:
    records: List[CallRecord]
    start: float  # when the first call started, failed or not
    failed: int = 0

    @property
    def end(self) -> float:
        return self.records[-1].end

    @property
    def seconds(self) -> float:
        """From the first call's start to the last call's end."""
        return self.end - self.start

    @property
    def attempted(self) -> int:
        return len(self.records) + self.failed

    def total(self, unit: str) -> float:
        return sum(r.units.get(unit, 0.0) for r in self.records)

    def rate(self, unit: str) -> float:
        """All the work of the window over all its measured time."""
        return self.total(unit) / self.seconds

    def durations(self) -> List[float]:
        return [r.seconds for r in self.records]


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of all values, interpolated
    linearly between the order statistics (numpy's default method)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def run_window(call: Callable[[int], tuple], seconds: float, *,
               clock: Callable[[], float] = time.perf_counter,
               min_calls: int = 1, after_call: Optional[Callable] = None) -> Window:
    """Run ``call(i)`` for i = 0, 1, ... back to back while fewer than
    ``seconds`` have passed since the first call started (and at least
    ``min_calls`` times). ``call`` returns ``(units, spans)`` and raises on a
    failed call, which is counted and not timed into a record.
    ``after_call(i, record)`` runs after each completed call."""
    records: List[CallRecord] = []
    failed = 0
    t0: Optional[float] = None
    i = 0
    while True:
        start = clock()
        if t0 is None:
            t0 = start
        elif start - t0 >= seconds and i >= min_calls:
            break
        try:
            units, spans = call(i)
        except Exception as exc:  # a failed call counts against the run
            failed += 1
            print(f"portbench: call {i} failed: {exc!r}", flush=True)
            i += 1
            continue
        rec = CallRecord(start, clock(), units, spans)
        records.append(rec)
        if after_call is not None:
            after_call(i, rec)
        i += 1
    if not records:
        raise RuntimeError(f"every call of the window failed ({failed})")
    return Window(records, t0, failed)
