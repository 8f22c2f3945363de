"""Whole runs of a cell on the CPU, at the sizes of its traffic file's
``cpu_test`` (the fused engine's plain versions stand in for the kernels
there), and the faults the harness's check has to catch, planted where
every sampler's draws and every summary pass:

- ``unchanged``: a step that returns its state unchanged (every draw is the
  initial point, never accepted);
- ``half``: half of the batch left out (the second half of the chains
  never run: zero draws, log densities and decisions);
- ``altered``: an answer altered where it is produced (every draw scaled
  by 1 + 1e-3 and shifted by 1e-3);
- ``half_summary``: ``summary()``'s statistics taken over half the chains.

The first three wrap ``runtime/fused.py::run``, the one call through which
``sample(engine="fused")`` gets every sampler's transitions; the last wraps
``Chains.summary``.

    python -m portbench.tests.cpu_runs --workload <name>

prints one JSON line: whether a sound run, a traced run, the bfloat16
control and each fault came out ``correct``, with their numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import sys
from typing import Iterator, Optional

import torch

from portbench import control, harness, spec

FAULTS = ("unchanged", "half", "altered", "half_summary")
SEED = 4_294_967_311
CONTROL_SEED = 2_147_483_659


def _unchanged(tr, model, kw):
    from advancedmh_tpu_torch.models import logdensity_batched

    C, N, d = tr.params.shape
    start = torch.as_tensor(kw["initial_params"], dtype=tr.params.dtype,
                            device=tr.params.device).reshape(1, d)
    lp0 = logdensity_batched(model, start).to(tr.lp.dtype).reshape(1, 1)
    return dataclasses.replace(tr, params=start.reshape(1, 1, d).expand(C, N, d).clone(),
                               lp=lp0.expand(C, N).clone(),
                               accepted=torch.zeros_like(tr.accepted))


def _half(tr, model, kw):
    half = tr.params.shape[0] // 2
    params, lp, acc = tr.params.clone(), tr.lp.clone(), tr.accepted.clone()
    params[half:], lp[half:], acc[half:] = 0.0, 0.0, False
    return dataclasses.replace(tr, params=params, lp=lp, accepted=acc)


def _altered(tr, model, kw):
    return dataclasses.replace(tr, params=tr.params * (1.0 + 1e-3) + 1e-3)


def _half_summary(orig):
    def broken(self):
        half = type(self)(self.values[:, :, : self.n_chains // 2],
                          self.lp[:, : self.n_chains // 2], self.names)
        return orig(half)
    return broken


@contextlib.contextmanager
def planted(fault: Optional[str]) -> Iterator[None]:
    """``fault`` (one of :data:`FAULTS`, or None for a sound run) planted
    for the duration of the block."""
    if fault is None:
        yield
        return
    import advancedmh_tpu_torch.runtime.fused as fused
    from advancedmh_tpu_torch.output.chains import Chains

    if fault == "half_summary":
        owner, name = Chains, "summary"
        broken = _half_summary(Chains.summary)
    else:
        owner, name = fused, "run"
        alter = {"unchanged": _unchanged, "half": _half, "altered": _altered}[fault]
        sound = fused.run

        def broken(model, sampler, schedule, **kw):
            tr, final = sound(model, sampler, schedule, **kw)
            return alter(tr, model, kw), final
    original = getattr(owner, name)
    setattr(owner, name, broken)
    try:
        yield
    finally:
        setattr(owner, name, original)


def run(workload: str, seed: int = SEED, trace: int = 0, seconds: float = 0.3,
        fault: Optional[str] = None) -> dict:
    """The result line of one run of ``workload`` on the CPU at its
    ``cpu_test`` sizes, with ``fault`` planted."""
    sizes = spec.cell(workload).traffic["cpu_test"]
    out = io.StringIO()
    with planted(fault), contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)], device="cpu",
                          traffic_overrides=sizes)
    if rc != 0:
        raise RuntimeError(f"{workload}: the run exited with {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def control_checks(workload: str, seed: int = CONTROL_SEED) -> list:
    """The bfloat16 control's checks of ``workload`` at its ``cpu_test`` sizes."""
    sizes = spec.cell(workload).traffic["cpu_test"]
    return control.run(workload, seed, torch.device("cpu"), sizes)


def verdicts(workload: str) -> dict:
    """Whether a sound run, a traced run, the control and each fault is
    ``correct``, and the directory of the harness that ran them."""
    sound = run(workload)
    traced = run(workload, trace=1)
    checks = control_checks(workload)
    out = {"harness": str(spec.PACKAGE_DIR),
           "sound": sound["correct"], "sound_checks": sound["checks"],
           "traced": traced["correct"], "traced_metrics": traced["metrics"],
           "control": all(c.ok for c in checks),
           "control_checks": {c.name: c.value for c in checks}}
    for fault in FAULTS:
        res = run(workload, fault=fault)
        out[fault] = res["correct"]
        out[f"{fault}_checks"] = res["checks"]
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    a = p.parse_args(argv)
    print(json.dumps(verdicts(a.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
