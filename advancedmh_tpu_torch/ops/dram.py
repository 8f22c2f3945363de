"""Fused DRAM: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_dram.py. The kernel (``csrc/dram.cu``) runs
burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. Both stages propose from the chain's running
covariance factor L and both densities are evaluated on every step:

    y₁ = x + s·L z₁,  acc₁ = log U₁ < lp₁ − lp,
    y₂ = x + (γs)·L z₂,
    dq = Σ_r −½((z₁ᵣ − γz₂ᵣ)² − z₁ᵣ²)   (the q₁ cross term in z-space),
    la₂ = lp₂ − lp + dq + log1m_exp(lp₁ − lp₂) − log1m_exp(lp₁ − lp),
    acc₂ = log U₂ < la₂ and not acc₁,

s = opt_scale/√d rounded once from float64, γ to float32 and γs their
float32 product (pallas_dram.py:52-53, 69); then (mean, L, n) advance with
the realized state (ops/am.py::welford_advance), as in AM.

Noise of absolute step j of a chain (csrc/common.cuh::StepWords): z₁'s
Box-Muller words 0 .. 2P−1, z₂'s 2P .. 4P−1, U₁ at 4P and U₂ at 4P+1.
Layout as ops/am.py. The wrapper runs the plain version for tensors on the
CPU, and for CUDA tensors launches the kernel or raises;
``fused_dram_sample.launches`` counts the launches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .am import check_am_family, launch_am_family, run_am_family, tri_rows, welford_advance
from .dr import log1m_exp
from .rwmh import box_muller, row_sum


@dataclasses.dataclass(frozen=True)
class DramParams:
    """The sampler's constants (≙ ``DRAM``'s opt_scale and gamma)."""

    opt_scale: float = 2.38
    gamma: float = 0.2

    def constants(self, d: int) -> Tuple[float, float, float]:
        """(s, γs, γ) as the kernel takes them, in float32."""
        s = np.float32(self.opt_scale / math.sqrt(d))
        g = np.float32(self.gamma)
        return float(s), float(g * s), float(g)


def dram_step(x, lp, mean, L, n, z1, z2, logu1, logu2, k, tile_fn, consts):
    """One DRAM step on the chain block (the kernel's arithmetic); ``k`` is
    :meth:`DramParams.constants`. Returns (x, lp, mean, L, n, accepted)."""
    s, gs, g = k
    dz = z1 - g * z2
    dq = row_sum(-0.5 * (dz * dz - z1 * z1))
    y1 = x + s * tri_rows(L, z1)
    lp1 = tile_fn(y1, *consts)
    la1 = lp1 - lp
    acc1 = logu1 < la1
    y2 = x + gs * tri_rows(L, z2)
    lp2 = tile_fn(y2, *consts)
    la2 = lp2 - lp + dq + log1m_exp(lp1 - lp2) - log1m_exp(la1)
    acc2 = (logu2 < la2) & ~acc1
    x = torch.where(acc1, y1, torch.where(acc2, y2, x))
    lp = torch.where(acc1, lp1, torch.where(acc2, lp2, lp))
    return (x, lp, *welford_advance(x, mean, L, n), acc1 | acc2)


def dram_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, mean: torch.Tensor, L: torch.Tensor, n: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, burn: int, thin: int, n_samples: int,
    params: DramParams = DramParams(), iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_dram_sample`; ``cuda_density`` is unused)."""
    d = params_t.shape[0]
    P = (d + 1) // 2
    k = params.constants(d)

    def step(x, l, m, L_, n_, u):
        return dram_step(x, l, m, L_, n_, box_muller(u[None], d)[0],
                         box_muller(u[None, :, 2 * P:], d)[0], torch.log(u[None, :, 4 * P]),
                         torch.log(u[None, :, 4 * P + 1]), k, tile_fn, consts)

    return run_am_family(step, 4 * P + 2, params_t, lp, mean, L, n, seed, burn, thin,
                         n_samples, iteration_offset)


def fused_dram_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, mean: torch.Tensor, L: torch.Tensor, n: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, burn: int, thin: int, n_samples: int,
    params: DramParams = DramParams(), iteration_offset: int = 0,
):
    """Burn-in + thinned DRAM with adaptation on every step
    (≙ pallas_dram.py::fused_dram_sample); the outputs of
    :func:`ops.am.fused_am_sample`."""
    check_am_family("DRAM", params_t, lp, mean, L, n, consts, burn, thin, n_samples)
    kw = dict(burn=burn, thin=thin, n_samples=n_samples, params=params,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return dram_sample_reference(tile_fn, cuda_density, params_t, lp, mean, L, n, consts,
                                     seed, **kw)
    out = launch_am_family("amh_dram_sample", "dram", cuda_density, params_t, lp, mean, L, n,
                           consts, params.constants(params_t.shape[0]), seed, burn, thin,
                           n_samples, iteration_offset)
    fused_dram_sample.launches += 1
    return out


fused_dram_sample.launches = 0
