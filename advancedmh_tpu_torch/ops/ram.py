"""Fused Robust Adaptive Metropolis: the CUDA kernel's wrapper and its
plain version.

≙ advancedmh_tpu/ops/pallas_ram.py. The kernel (``csrc/ram.cu``) runs
``warmup`` adaptive steps, then ``n_samples`` thinned draws with the factor S
frozen; sample k is the state after ``warmup + (k+1)*thin`` steps. A step
proposes ``y = x + S U``, takes ``logα = min(lp_y − lp, 0)`` (NaN stays
NaN), accepts iff ``-log u > -logα``, and during warmup step t (1-based)
adapts S by the rank-1 Cholesky update/downdate of size
``sqrt(t^-γ |Δα|) S U / |U|`` with ``Δα = exp(logα) − α``, keeping the old S
when the sweep fails or, with eigenvalue bounds, a diagonal entry leaves
them. The noise is RWMH's (ops/common.py::step_noise: U from the d normals).

Layout: chains on the last axis, x ``(d, C)``, lp ``(1, C)``, S ``(d*d, C)``
row-major per chain. The wrapper runs the plain version for tensors on the
CPU, and for CUDA tensors launches the kernel or raises;
``fused_ram_sample.launches`` counts the launches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.trace import traced
from . import _build
from .cholesky import chol_rank1_update_batched
from .common import noise_chunk, row_sum, step_noise

_TINY = float(np.finfo(np.float32).tiny)
MAX_DIM = 8  # as pallas_ram.py: the kernel unrolls the d x d sweep


@dataclasses.dataclass(frozen=True)
class RamParams:
    """The kernel's adaptation constants, rounded to float32."""

    alpha: float = 0.234
    gamma: float = 0.6
    eig_lo: float = 0.0
    eig_hi: float = math.inf

    def __post_init__(self):
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, float(np.float32(getattr(self, f.name))))

    @property
    def clamp(self) -> bool:
        """Whether the eigenvalue bounds are checked (not the default (0, ∞))."""
        return not (self.eig_lo == 0.0 and math.isinf(self.eig_hi))


def _tril_matvec(S: torch.Tensor, U: torch.Tensor, d: int):
    """Rows of S·U for S (d*d, C) row-major and U (d, C), by column
    accumulation (the kernel's order)."""
    return torch.cat([row_sum(S[i * d : (i + 1) * d] * U) for i in range(d)])


def ram_step(x, lp, S, U, logu, params: RamParams, t: Optional[int],
             tile_fn, consts):
    """One RAM step on the chain block; adapts S at warmup step ``t``
    (1-based) unless ``t`` is None. Returns (x, lp, S, accepted)."""
    d = x.shape[0]
    SU = _tril_matvec(S, U, d)
    y = x + SU
    lp_new = tile_fn(y, *consts)
    diff = lp_new - lp
    logalpha = torch.where(diff > 0, torch.zeros_like(diff), diff)  # NaN stays
    accept = -logu[None] > -logalpha
    x = torch.where(accept, y, x)
    lp = torch.where(accept, lp_new, lp)
    if t is None:
        return x, lp, S, accept
    dalpha = torch.exp(logalpha) - params.alpha
    t_f = torch.full_like(dalpha, float(t))
    eta = torch.exp(-params.gamma * torch.log(t_f))
    norm_u = torch.sqrt(row_sum(U * U))
    coeff = torch.sqrt(eta * torch.abs(dalpha)) / torch.clamp(norm_u, min=_TINY)
    one = torch.ones_like(dalpha)
    sgn = torch.where(dalpha > 0, one, torch.where(dalpha < 0, -one, dalpha))
    C = x.shape[1]
    L, ok = chol_rank1_update_batched(S.T.reshape(C, d, d), (coeff * SU).T, sgn[0])
    S_new = L.reshape(C, d * d).T
    valid = ok[None]
    if params.clamp:
        for k in range(d):
            diag = S_new[k * d + k : k * d + k + 1]
            valid = valid & (diag >= params.eig_lo) & (diag <= params.eig_hi)
    return x, lp, torch.where(valid, S_new, S), accept


def ram_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, S: torch.Tensor, consts: Sequence[torch.Tensor],
    seed: int, *, warmup: int, thin: int, n_samples: int,
    params: RamParams = RamParams(), iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_ram_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    x, l, s_rows = params_t, lp, S
    n_steps = warmup + n_samples * thin
    chunk = noise_chunk(n_chains)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        U, logu = step_noise(seed, iteration_offset + 1 + t0, n, n_chains, d,
                             params_t.device)
        for t in range(n):
            step = t0 + t + 1
            x, l, s_rows, acc = ram_step(
                x, l, s_rows, U[t], logu[t], params,
                step if step <= warmup else None, tile_fn, consts)
            if step > warmup and (step - warmup) % thin == 0:
                e = (step - warmup) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, s_rows


@traced("kernel.ram")
def fused_ram_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, S: torch.Tensor, consts: Sequence[torch.Tensor],
    seed: int, *, warmup: int, thin: int, n_samples: int,
    params: RamParams = RamParams(), iteration_offset: int = 0,
):
    """Adaptive warmup + frozen-S thinned RAM (≙ pallas_ram.py::fused_ram_sample).

    Returns samples ``(n_samples, d, C)``, lps and accepted
    ``(n_samples, 1, C)`` (float32 0/1) and the final S ``(d*d, C)``."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    d, n_chains = params_t.shape
    if d > MAX_DIM:
        raise ValueError(f"fused RAM unrolls the d x d sweep; d <= {MAX_DIM}, got {d}")
    if tuple(lp.shape) != (1, n_chains) or tuple(S.shape) != (d * d, n_chains):
        raise ValueError(f"lp must be (1, {n_chains}) and S ({d * d}, {n_chains})")
    if min(warmup, thin - 1, n_samples - 1) < 0:
        raise ValueError("warmup >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, S, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp, S and consts must be on one device")
    kw = dict(warmup=warmup, thin=thin, n_samples=n_samples, params=params,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return ram_sample_reference(tile_fn, cuda_density, params_t, lp, S,
                                    consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    p, l, s = params_t.contiguous(), lp.contiguous(), S.contiguous()
    flat, n_consts = _build.flat_consts(consts, p.device)
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    S_out = torch.empty((d * d, n_chains), **f32)
    _build.launch("amh_ram_sample", "ram", cuda_density, d, p.device, int(params.clamp), p, l,
                  s, flat, n_consts, params.alpha, params.gamma, params.eig_lo, params.eig_hi,
                  seed, warmup, thin, n_samples, iteration_offset, n_chains, samples, lps,
                  accs, S_out)
    fused_ram_sample.launches += 1
    return samples, lps, accs, S_out


fused_ram_sample.launches = 0
