"""Fused differential-evolution MCMC: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_demc.py. The kernel (``csrc/demc.cu``) runs
burn-in, then ``n_samples`` thinned draws of the red-black DE-MC move on one
population of M members (any even M ≥ 6; the JAX engine's multiple-of-256
rule and its tiles of independent populations are TPU lane facts the port
drops), halves of H = M/2: the first half moves against the frozen second,
then the second against the updated first. A moving member x draws two
distinct members r1, r2 of the other half and proposes

    y = (x + g·(x_r1 − x_r2)) + noise·z,   g = 1 with probability p_jump, else γ,

or, with probability p_snooker, the snooker move along e = x − x_z:
``y = x + ((γ_s·(x_r1 − x_r2)·e)·(1/|e|²))·e`` with the Hastings term
``(d−1)/2·(log|y − x_z|² − log|e|²)`` (−1e30 when a 1e-30 guard fails). It
accepts iff ``log u < (lp(y) − lp(x)) + log ratio``.

Indices from the uniforms: r1 = ⌊u·H⌋ clamped to H−1; r2 = ⌊u·(H−1)⌋
clamped to H−2, bumped past r1; z = ⌊u·(H−2)⌋ clamped to H−3, bumped past
min(r1, r2) and then max(r1, r2).

Noise of absolute step j of member w (csrc/common.cuh::StepWords with the
member as the chain): word 0 r1, 1 r2, 2 the jump, 3 the accept uniform,
4 .. 4+2P−1 the normals (P = ⌈d/2⌉), 4+2P the snooker member, 4+2P+1 the
snooker choice.

Layout: members on the last axis, params ``(d, M)``, lp ``(1, M)``. The
wrapper runs the plain version for tensors on the CPU, and for CUDA tensors
launches the kernel or raises; ``fused_demc_sample.launches`` counts the
launches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..utils.trace import traced
from . import _build
from .common import box_muller, noise_chunk, philox_uniforms, row_sum


@dataclasses.dataclass(frozen=True)
class DemcParams:
    """The move's constants (each rounded once to float32 where it is used)."""

    gamma: float
    noise_scale: float = 1e-4
    jump_probability: float = 0.1
    snooker_probability: float = 0.0
    snooker_gamma: float = 1.683


def check_members(n_members: int) -> None:
    """One population of any even M >= 6."""
    if n_members % 2 or n_members < 6:
        raise ValueError(f"n_members must be even and >= 6, got {n_members}")


def demc_words(d: int) -> int:
    """Philox words one member-step reads (the snooker's two included)."""
    return 4 + 2 * ((d + 1) // 2) + 2


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def demc_indices(u: torch.Tensor, H: int, snooker: bool):
    """The members r1, r2 (and z) in the other half from the uniforms of
    words 0, 1 (and 4+2P) ``(n,)`` each."""
    r1 = torch.clamp(torch.floor(u[0] * float(H)).to(torch.int64), max=H - 1)
    r2 = torch.clamp(torch.floor(u[1] * float(H - 1)).to(torch.int64), max=H - 2)
    r2 = r2 + (r2 >= r1).to(torch.int64)
    if not snooker:
        return r1, r2, None
    rz = torch.clamp(torch.floor(u[2] * float(H - 2)).to(torch.int64), max=H - 3)
    lo, hi = torch.minimum(r1, r2), torch.maximum(r1, r2)
    rz = rz + (rz >= lo).to(torch.int64)
    rz = rz + (rz >= hi).to(torch.int64)
    return r1, r2, rz


def snooker_move(xa, diff, xz, snooker_gamma, half_dm1):
    """The snooker proposal and its log Hastings term for members ``xa``
    ``(d, n)`` with their difference vectors and third members ``xz``."""
    e = xa - xz
    ee = row_sum(e * e)
    de = row_sum(diff * e)
    safe = ee > 1e-30
    inv = torch.where(safe, torch.ones_like(ee) / torch.clamp(ee, min=1e-30),
                      torch.zeros_like(ee))
    coef = snooker_gamma * de * inv
    ys = xa + coef * e
    ey = ys - xz
    ee_y = row_sum(ey * ey)
    log_j = torch.where(safe & (ee_y > 1e-30),
                        half_dm1 * (torch.log(torch.clamp(ee_y, min=1e-30))
                                    - torch.log(torch.clamp(ee, min=1e-30))),
                        torch.full_like(ee, -1e30))
    return ys, log_j


def demc_move(x, lp, active, other, r1, r2, jump, z, rz, pick, logu, prm: DemcParams, tile_fn,
              consts):
    """The kernel's half-move given its draws, in place on x ``(d, M)`` and
    lp ``(1, M)``: the members ``active`` (H,) move against the half starting
    at ``other`` with the final indices r1, r2 (and rz) ``(H,)``, the jump
    and snooker choices ``(1, H)``, the normals z ``(d, H)`` and log u
    ``(1, H)``. Returns the accept flags ``(1, H)``."""
    d = x.shape[0]
    dev = x.device
    g = torch.where(jump, _f32(1.0, dev), _f32(prm.gamma, dev))
    xa, lp_a = x[:, active], lp[:, active]
    diff = x[:, other + r1] - x[:, other + r2]
    y = (xa + g * diff) + _f32(prm.noise_scale, dev) * z
    log_ratio = torch.zeros_like(lp_a)
    if prm.snooker_probability > 0.0:
        ys, log_j = snooker_move(xa, diff, x[:, other + rz], _f32(prm.snooker_gamma, dev),
                                 _f32(0.5 * (d - 1), dev))
        y = torch.where(pick, ys, y)
        log_ratio = torch.where(pick, log_j, log_ratio)
    lp_y = tile_fn(y, *consts)
    accept = logu < lp_y - lp_a + log_ratio
    x[:, active] = torch.where(accept, y, xa)
    lp[:, active] = torch.where(accept, lp_y, lp_a)
    return accept


def demc_half_move(x, lp, active, other, u, prm: DemcParams, tile_fn, consts):
    """Move the members ``active`` (H,) against the half starting at
    ``other``, in place on x ``(d, M)`` and lp ``(1, M)``, with their
    uniforms ``u`` ``(H, W)`` (the word layout above). Returns the accept
    flags ``(1, H)``."""
    d = x.shape[0]
    H = active.shape[0]
    P = (d + 1) // 2
    dev = x.device
    r1, r2, rz = demc_indices((u[:, 0], u[:, 1], u[:, 4 + 2 * P]), H,
                              prm.snooker_probability > 0.0)
    jump = u[None, :, 2] < _f32(prm.jump_probability, dev)
    pick = u[None, :, 4 + 2 * P + 1] < _f32(prm.snooker_probability, dev)
    return demc_move(x, lp, active, other, r1, r2, jump, box_muller(u[None, :, 4:], d)[0], rz,
                     pick, torch.log(u[None, :, 3]), prm, tile_fn, consts)


def demc_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, params: DemcParams,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_demc_sample`; ``cuda_density`` is unused)."""
    d, M = params_t.shape
    H = M // 2
    dev = params_t.device
    f32 = dict(dtype=torch.float32, device=dev)
    samples = torch.empty((n_samples, d, M), **f32)
    lps = torch.empty((n_samples, 1, M), **f32)
    accs = torch.empty((n_samples, 1, M), **f32)
    x, l = params_t.clone(), lp.clone()
    W = demc_words(d)
    halves = torch.arange(M, device=dev).view(2, H)
    n_steps = burn + n_samples * thin
    chunk = noise_chunk(M, W)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, iteration_offset + 1 + t0, n, M, W, dev)
        for t in range(n):
            acc = torch.cat([demc_half_move(x, l, halves[h], (1 - h) * H, u[t, halves[h]],
                                            params, tile_fn, consts) for h in (0, 1)], 1)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs


@traced("kernel.demc")
def fused_demc_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, params: DemcParams,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned red-black DE-MC on one population (≙
    pallas_demc.py::fused_demc_sample). Returns samples ``(n_samples, d, M)``,
    lps and accepted ``(n_samples, 1, M)`` (float32 0/1)."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, M) tensor")
    d, M = params_t.shape
    check_members(M)
    if tuple(lp.shape) != (1, M) or lp.dtype != torch.float32:
        raise ValueError(f"lp must be a float32 (1, {M}) tensor")
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    if not 0.0 <= params.snooker_probability <= 1.0:
        raise ValueError("snooker_probability must be in [0, 1]")
    for t in (lp, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp and consts must be on one device")
    kw = dict(params=params, burn=burn, thin=thin, n_samples=n_samples,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return demc_sample_reference(tile_fn, cuda_density, params_t, lp, consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    x_state = params_t.to(torch.float32, copy=True).contiguous()
    lp_state = lp.to(torch.float32, copy=True).contiguous()
    flat, n_consts = _build.flat_consts(consts, x_state.device)
    f32 = dict(dtype=torch.float32, device=x_state.device)
    samples = torch.empty((n_samples, d, M), **f32)
    lps = torch.empty((n_samples, 1, M), **f32)
    accs = torch.empty((n_samples, 1, M), **f32)
    _build.launch("amh_demc_sample", "demc", cuda_density, d, x_state.device, x_state,
                  lp_state, flat, n_consts, float(params.gamma), float(params.noise_scale),
                  float(params.jump_probability), float(params.snooker_probability),
                  float(params.snooker_gamma), 0.5 * (d - 1), M, seed, burn, thin, n_samples,
                  iteration_offset, samples, lps, accs)
    fused_demc_sample.launches += 1
    return samples, lps, accs


fused_demc_sample.launches = 0
