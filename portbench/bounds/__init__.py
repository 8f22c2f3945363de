"""The yardstick: float32 operations and bytes a launch needs, and the peaks.

A frozen copy of ``chip_smoke.py::bound`` (with the flagship's ``_FLOPS``)
at commit 63ce544. The copy is the benchmark's own: the program may change,
the counts may not.
Each function returns ``(bytes, flops)``; :func:`bound_seconds` turns them
into the least time the card could take, the larger of bytes over the
bandwidth and operations over the float32 rate.

Counting rules (from the sources, as chip_smoke counts them): each float32
add, multiply, divide, compare-select, sqrt, log, exp and sincos counts one;
Philox's integer arithmetic is not counted; each input is read once and each
output written once.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

_PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
PEAK_BYTES_PER_S = float(_PEAKS["hbm_bytes_per_s"])
PEAK_F32_PER_S = float(_PEAKS["f32_flops_per_s"])


def bound_seconds(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the bandwidth and the operations over the
    float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)


# ---- the flagship, d = 2, one thread a chain (chip_smoke.py::_FLOPS, bound) ----

FLAGSHIP_N_OBS = 30
RWMH_STEP_OPS = 15 + 4 + (5 * FLAGSHIP_N_OBS + 7) + 2


def rwmh_sample(C: int, steps: int, emitted: int, d: int = 2) -> Tuple[int, int]:
    """``amh::rwmh_sample_kernel``: x and lp in, the constants, the draws
    (d + 2 floats a chain and draw) out; ``RWMH_STEP_OPS`` a chain-step."""
    nbytes = (d + 1) * C * 4 + FLAGSHIP_N_OBS * 4 + emitted * (d + 2) * C * 4
    return nbytes, RWMH_STEP_OPS * C * steps
