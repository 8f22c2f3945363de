"""Plain random-walk Metropolis, the reference of the fused RWMH path.

Copied from ``advancedmh_tpu_torch/ops/rwmh.py::rwmh_step`` and the
schedule of ``runtime/fused.py`` (commit 63ce544), restated over a batch of
(chain, step) pairs: a step proposes ``x + s·z`` with the step's normals z
and accepts iff ``log u < log p(x') − log p(x)`` (a NaN difference, as
between two points outside the support, rejects). Draw k of a call is the
state after ``burn + (k + 1)·thin`` steps, ``burn = max(discard_initial −
thin, 0)``; step t of the call draws the noise of absolute step t.
The noise of a step is ``philox.step_noise``'s: the d normals and log u,
2P + 1 Philox words (:func:`noise`). Plain PyTorch; imports nothing of the
program.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from . import philox


def plan(traffic: dict) -> dict:
    """What a replay needs beyond the noise: the scale and the schedule."""
    thin = int(traffic["thinning"])
    return {"scale": float(traffic["sampler"]["args"][0]["kwargs"]["scale"]),
            "burn": max(int(traffic["discard_initial"]) - thin, 0), "thin": thin}


def steps_before(plan_: dict, k: int) -> int:
    """Steps of the call before draw k."""
    return plan_["burn"] + (k + 1) * plan_["thin"]


def noise(plan_: dict, seed: int, chain: torch.Tensor, first: torch.Tensor, d: int,
          dtype=torch.float64, chunk: int = 1) -> philox.NoiseStream:
    """The noise :func:`replay` consumes: consecutive steps of chains
    ``chain`` from absolute steps ``first`` on, under the kernels' Philox
    ``seed``, computed ``chunk`` steps at a time in ``dtype``."""
    return philox.NoiseStream(seed, chain, first, d, dtype, chunk)


def replay(logp: Callable, plan_: dict, noise: philox.NoiseStream, x: torch.Tensor,
           n_steps: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``n_steps`` steps from points ``x`` (M, d) under the next steps of
    ``noise``. Returns the end points, their log densities and the last
    step's decisions."""
    lp = logp(x)
    acc = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(n_steps):
        z, logu, _ = noise.next()
        cand = x + plan_["scale"] * z.to(x.dtype)
        lp_c = logp(cand)
        acc = logu.to(x.dtype) < lp_c - lp
        x = torch.where(acc[:, None], cand, x)
        lp = torch.where(acc, lp_c, lp)
    return x, lp, acc
