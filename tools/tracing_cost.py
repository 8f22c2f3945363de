#!/usr/bin/env python3
"""What the program's spans cost when they are on: the benchmark's untraced
window of a cell, with each call inside ``advancedmh_tpu_torch.tracing()``
and without, same seeds, in turns (off, on, on, off) in one process.

    python3 tools/tracing_cost.py --workload flagship.rwmh --seconds 20 --seeds 11 12

Each turn is ``portbench/run.py``'s run (``portbench.harness.main``) with
``--trace 0``; with tracing on, the sample driver's calls (warm-up and
window) run inside ``tracing()``, so the spans record on the host clock
with no profiler, and the recorded spans are dropped after the turn. Prints
the card's name and power limit, one line per turn (``ess_per_s``,
``call_p95_s``, calls, spans recorded; with tracing on, each span name's
host milliseconds and count a call, children included) and the median
change of each metric, on over off. Needs one CUDA GPU.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def by_name(spans, n_calls: int) -> str:
    """Each span name's host milliseconds and count a call."""
    totals = collections.defaultdict(lambda: [0, 0])
    for s in spans:
        totals[s.name][0] += s.end_ns - s.start_ns
        totals[s.name][1] += 1
    return ", ".join(f"{name} {ns * 1e-6 / n_calls:.4f} ms x{k / n_calls:g}"
                     for name, (ns, k) in sorted(totals.items()))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import advancedmh_tpu_torch as amh
    from advancedmh_tpu_torch.utils import trace
    from portbench import harness, spec

    name = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no CUDA device"
    print(f"card: {name}, power limit {harness.power_limit_w()} W", flush=True)
    driver = spec.cell(args.workload).driver().SampleDriver
    plain_run = driver.run

    def traced_run(self, key, span):
        with amh.tracing():
            return plain_run(self, key, span)

    rows = {False: [], True: []}
    for seed in args.seeds:
        for on in (False, True, True, False):
            driver.run = traced_run if on else plain_run
            trace.clear()
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    rc = harness.main(["--workload", args.workload, "--seed", str(seed),
                                       "--seconds", str(args.seconds), "--trace", "0"])
            finally:
                driver.run = plain_run
            spans = trace.recorded()
            trace.clear()
            if rc != 0:
                print(f"turn failed with {rc}", flush=True)
                return rc
            res = json.loads(out.getvalue().strip().splitlines()[-1])
            m = {k: v["value"] for k, v in res["metrics"].items()}
            rows[on].append(m)
            print(f"seed {seed} tracing {'on ' if on else 'off'}: ess_per_s {m['ess_per_s']!r} "
                  f"call_p95_s {m['call_p95_s']!r} calls {res['attempted']} spans {len(spans)} "
                  f"correct {res['correct']}", flush=True)
            if spans:  # the warm-up calls ran inside tracing() too
                print("  " + by_name(spans, res["attempted"] + harness.N_WARMUP), flush=True)
    for name in ("ess_per_s", "call_p95_s"):
        off = statistics.median(r[name] for r in rows[False])
        on = statistics.median(r[name] for r in rows[True])
        print(f"{name}: off {off!r}, on {on!r}, on/off - 1 = {100.0 * (on / off - 1.0):+.3f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
