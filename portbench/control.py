#!/usr/bin/env python3
"""The control of a cell's check: the plain reference put in the program's
place, computed in bfloat16 (the precision below the configuration's
float32), judged by the same comparisons as a run. Every number it reads is an upper
reading of that number's limit (PERF.md); a control that passed a limit
would show that limit too loose.

    python3 portbench/control.py --workload <name> --seeds 11,12,13

Every chain of the cell runs under the reference in bfloat16 from the
cell's initial point, then the reference ``summary()`` runs in bfloat16.

One JSON line per seed with each number beside its limit; the runs' own
harness never runs this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import judge, spec  # noqa: E402
from portbench.harness import call_key  # noqa: E402
from portbench.reference import philox  # noqa: E402
from portbench.reference import summary as ref_summary  # noqa: E402

BF16 = torch.bfloat16


def control_draws(driver, key: int) -> judge.Draws:
    """Every chain of the cell under the reference in bfloat16."""
    ref = driver.reference
    C, N = driver.kwargs["num_chains"], driver.n_samples
    d = driver.initial.numel()
    dev = driver.device
    dens = driver.cfgmod.reference_logp(driver.cell.config, driver.data, BF16)
    params = torch.empty((C, N, d), dtype=torch.float32, device=dev)
    lp = torch.empty((C, N), dtype=torch.float32, device=dev)
    acc = torch.empty((C, N), dtype=torch.bool, device=dev)
    chain = torch.arange(C, device=dev)
    x = driver.initial.to(BF16).reshape(1, d).expand(C, d).contiguous()
    plan = ref.plan(driver.traffic)
    noise = ref.noise(plan, philox.kernel_seed(key), chain,
                      torch.ones(C, dtype=torch.long, device=dev), d, torch.float32, 64)
    x, l, a = ref.replay(dens, plan, noise, x, ref.steps_before(plan, 0))
    params[:, 0], lp[:, 0], acc[:, 0] = x.float(), l.float(), a
    for k in range(1, N):
        x, l, a = ref.replay(dens, plan, noise, x, plan["thin"])
        params[:, k], lp[:, k], acc[:, k] = x.float(), l.float(), a
    summary = ref_summary.summarize(params.permute(1, 2, 0), driver.names, BF16)
    return judge.Draws(params, lp, acc, summary)


def run(workload: str, seed: int, device, traffic_overrides=None) -> list:
    """The control's checks of one seed."""
    cell = spec.cell(workload)
    if traffic_overrides:
        cell.traffic.update(traffic_overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfgmod = cell.config_module()
    data = cfgmod.make_data(cell.config, seed, device)
    driver = cell.driver().prepare(cell, cfgmod, data, device)
    key = call_key(seed, 0)
    return driver.judge_draws(control_draws(driver, key), key, seed)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        checks = run(a.workload, seed, torch.device(a.device))
        print(json.dumps({"workload": a.workload, "seed": seed, "control": "bfloat16",
                          "failed_by_control": [c.name for c in checks if not c.ok],
                          "checks": {c.name: {"value": c.value, "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
