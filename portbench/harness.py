"""One run of one cell: set-up, warm-up, the measured window, the check.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

1. Set-up: the cell's files are read by name (``spec.py``), its data made
   from ``--seed`` (``configs/<config>.py``), the program's model and the
   traffic's call prepared (``drivers/<call>.py``), and ``N_WARMUP`` calls
   of the same shapes run, which build or load the kernels and the
   diagnostics' FFT plans. ``setup_s`` runs from the process's start to the
   window's; its phases go to standard error (``start`` is the interpreter,
   the imports and the look for a card).
2. The window (``window.py``): calls back to back; call i runs with the key
   ``fold_in(seed, i)``. One call completed in the window, drawn from the
   seed, is kept for the check; the others are freed as they finish.
3. With ``--trace 1`` the window is ``TRACE_SECONDS`` (or ``--seconds``, if
   shorter) under ``torch.profiler``; its per-layer metrics are read from
   the trace and the benchmark's spans (``metrics/<name>.py``).
4. The check (``judge.py``), after the window and the memory peak: the kept
   call's outputs against the plain reference. The run is ``correct`` when
   no call failed and every compared number is within its limit.
5. The result: the last line of standard output is one JSON object; the
   numbers compared, each beside its limit, are the last lines of standard
   error and the result's last key.

A run needs as many CUDA devices as the cell's ``chips``; with fewer it
prints no result and exits with 2. It exits with 3, and prints no result,
if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench import spec
from portbench.reference.philox import MASK64, fold_in
from portbench.trace import SPAN_PREFIX, breakdown, read_profile
from portbench.window import Window, run_window

N_WARMUP = 2
TRACE_SECONDS = 4.0
FORBIDDEN = ("jax", "jaxlib", "flax", "advancedmh_tpu")


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def call_key(seed: int, i: int) -> int:
    """The key of window call i: from the seed and i alone."""
    return fold_in(seed & MASK64, i)


def warmup_key(seed: int, w: int) -> int:
    return fold_in(fold_in(seed & MASK64, 1 << 62), w)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """The benchmark's spans of one call: host seconds by name, and in a
    traced run a ``record_function("portbench.<name>")`` in the trace."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t = time.perf_counter()
        if self.tracing:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t

    def take(self) -> Dict[str, float]:
        out, self.seconds = self.seconds, {}
        return out


class Reservoir:
    """Keeps one completed call, each equally likely, drawn from the seed."""

    def __init__(self, seed: int):
        self.rng = random.Random(fold_in(seed & MASK64, 0xC4EC))
        self.seen = 0
        self.kept = None

    def offer(self, item) -> None:
        self.seen += 1
        if self.rng.randrange(self.seen) == 0:
            self.kept = item


@dataclasses.dataclass
class Context:
    """What the metric readers read (``readers.py``)."""
    cell: spec.Cell
    setup_s: float
    window: Optional[Window] = None
    trace: Optional[object] = None
    calls: List[dict] = dataclasses.field(default_factory=list)


def launch_counts() -> Dict[str, int]:
    from advancedmh_tpu_torch.ops import KERNEL_WRAPPERS

    return {name: w.launches for name, w in KERNEL_WRAPPERS.items()}


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    """JAX or the JAX package among the loaded modules, compared by whole
    top-level names (``advancedmh_tpu_torch`` is not ``advancedmh_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, t_start: Optional[float] = None, *, device=None,
         traffic_overrides: Optional[dict] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    cell = spec.cell(args.workload)
    if traffic_overrides:
        cell.traffic.update(traffic_overrides)
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell.chips:
            print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), found {found}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = [("start", time.perf_counter() - t_start)]

    def phase(name: str) -> None:
        synchronize(device)
        phases.append((name, time.perf_counter() - t_start - sum(s for _, s in phases)))

    cfgmod = cell.config_module()
    data = cfgmod.make_data(cell.config, args.seed, device)
    phase("data")
    driver = cell.driver().prepare(cell, cfgmod, data, device)
    phase("prepare")
    spans = Spans(tracing=bool(args.trace))
    for w in range(N_WARMUP):
        driver.run(warmup_key(args.seed, w), spans.span)
        phase(f"warm-up {w}")
    spans.take()
    setup_s = time.perf_counter() - t_start
    print(f"portbench setup_s {setup_s:.3f}: "
          + ", ".join(f"{n} {s:.3f}" for n, s in phases), file=sys.stderr, flush=True)

    reservoir = Reservoir(args.seed)
    pending = {}
    calls: List[dict] = []

    def call(i: int):
        key = call_key(args.seed, i)
        before = launch_counts() if args.trace else None
        with spans.span("call"):
            units, handle = driver.run(key, spans.span)
            synchronize(device)
        pending.update(key=key, handle=handle, before=before)
        return units, spans.take()

    def after_call(i: int, record) -> None:
        if args.trace:
            after = launch_counts()
            launched = {k: after[k] - pending["before"][k] for k in after}
            calls.append({"record": record, "info": driver.info(pending["handle"], launched)})
        reservoir.offer((pending["key"], pending["handle"]))
        pending.clear()

    trace = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            window = run_window(call, min(args.seconds, TRACE_SECONDS), min_calls=2,
                                after_call=after_call)
        trace = read_profile(prof)
    else:
        window = run_window(call, args.seconds, after_call=after_call)

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                else device.type,
                "count": cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                if device.type == "cuda" else 0}
    ctx = Context(cell, setup_s, None if args.trace else window, trace, calls)
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = m.reader().read(ctx)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    result = {"correct": False, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev_info}
    if trace is not None:
        lo, hi = trace.window()
        dev_info.update(busy_s=trace.busy_us(lo, hi) * 1e-6, window_s=(hi - lo) * 1e-6)
        result["breakdown"] = breakdown(trace)
    if device.type == "cuda":
        dev_info["power_limit_w"] = power_limit_w()

    key, handle = reservoir.kept
    reservoir.kept = None
    calls.clear()
    trace = ctx = None
    checks = driver.judge(key, handle, args.seed)
    del handle
    result["correct"] = window.failed == 0 and all(c.ok for c in checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for c in checks:
        print(f"portbench check {c.name}: {c.value!r} (limit {c.limit!r})"
              f"{'' if c.ok else ' FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
