"""Fused replica exchange: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_tempering.py. The kernel (``csrc/tempering.cu``)
runs burn-in, then ``n_samples`` thinned draws of a ladder of K tempered
random-walk replicas per chain plus the even-odd swap sweep, and emits the
cold replica (β₀ = 1); sample e is its state after ``burn + (e+1)*thin``
steps. It carries the raw log density ℓ_k of every replica and tempers on
use. A step:

1. replica k: y = x_k + s_k ⊙ z, accept iff log u_k < β_k·(ℓ(y) − ℓ_k);
2. pairs (k, k+1), k even then k odd:
   log α = (β_k − β_{k+1})·(ℓ_{k+1} − ℓ_k), swap positions and ℓ iff
   log u < log α — by a select, not the Pallas kernel's blend, whose
   0·(−∞) makes a NaN for a replica outside the support.

β_k − β_{k+1} is taken in float64 and rounded once and s_k is the float32
product of the replica's factor and the base scale, as the Pallas kernel's
constants are (:func:`ladder_constants`).

Noise of absolute step j of a chain (csrc/common.cuh::StepWords,
P = ⌈d/2⌉): replica k's normals are words k(2P+1) .. k(2P+1)+2P−1, its
accept uniform word k(2P+1)+2P, the swap of pair (k, k+1) word
K(2P+1)+k.

Layout: chains on the last axis; the ladder x ``(K·d, C)`` (replica k at
rows k·d .. k·d+d−1) and ℓ ``(K, C)``. The wrapper runs the plain version
for tensors on the CPU, and for CUDA tensors launches the kernel or raises;
``fused_tempering_sample.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.trace import traced
from . import _build
from .common import box_muller, noise_chunk, philox_uniforms

MAX_LADDER = 64  # K·d, the Pallas kernel's unrolled rows (pallas_tempering.py:208)


def ladder_constants(betas, scale, d: int, replica_scales=None, device="cuda"):
    """The ladder as the kernel takes it: β ``(K,)``, β_k − β_{k+1}
    ``(K−1,)`` (float64, rounded once) and the per-replica scales ``(K, d)``
    (the float32 product of ``replica_scales[k]`` and the base ``scale``, a
    scalar or per-dimension). Raises for K < 2, K·d > 64 and a
    ``replica_scales`` of the wrong length."""
    b = [float(v) for v in betas]
    K = len(b)
    if K < 2:
        raise ValueError("tempering needs at least 2 temperatures")
    if K * d > MAX_LADDER:
        raise ValueError(
            f"fused tempering holds K·d ladder rows per chain; K*d={K * d} > {MAX_LADDER} - "
            "use engine='torch' for larger ladders/dimensions.")
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32).cpu().numpy()
    base = np.broadcast_to(f32(scale), (d,))
    rs = np.ones((K,), np.float32) if replica_scales is None else f32(replica_scales)
    if rs.shape != (K,):
        raise ValueError(f"replica_scales must have shape ({K},)")
    scales = rs[:, None] * base[None, :]
    dbetas = np.asarray([b[k] - b[k + 1] for k in range(K - 1)], np.float64)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return as_t(b), as_t(dbetas), as_t(scales)


def tempering_step(x, ell, z, logu, logu_swap, betas, dbetas, scales, tile_fn, consts):
    """One step of the ladder, in place on the lists ``x`` (K tensors
    ``(d, C)``) and ``ell`` (K tensors ``(1, C)``), with its noise: normals
    ``(K, d, C)``, the moves' ``log u`` ``(K, C)`` and the swaps' ``(K−1, C)``.
    Returns the replicas' move decisions (K tensors ``(1, C)``, before the
    swaps; the kernel emits the cold one's) and the swap decisions (K−1
    tensors ``(1, C)``)."""
    K = len(x)
    moved = []
    for k in range(K):
        y = x[k] + scales[k][:, None] * z[k]
        ell_y = tile_fn(y, *consts)
        accept = logu[k:k + 1] < betas[k] * (ell_y - ell[k])
        x[k] = torch.where(accept, y, x[k])
        ell[k] = torch.where(accept, ell_y, ell[k])
        moved.append(accept)
    swaps = [None] * (K - 1)
    for parity in (0, 1):
        for k in range(parity, K - 1, 2):
            m = logu_swap[k:k + 1] < dbetas[k] * (ell[k + 1] - ell[k])
            x[k], x[k + 1] = torch.where(m, x[k + 1], x[k]), torch.where(m, x[k], x[k + 1])
            ell[k], ell[k + 1] = (torch.where(m, ell[k + 1], ell[k]),
                                  torch.where(m, ell[k], ell[k + 1]))
            swaps[k] = m
    return moved, swaps


def tempering_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], x_t: torch.Tensor, ell: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, betas, scale, replica_scales=None,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_tempering_sample`; ``cuda_density`` is unused)."""
    K = ell.shape[0]
    d, n_chains = x_t.shape[0] // K, x_t.shape[1]
    dev = x_t.device
    b, db, sc = ladder_constants(betas, scale, d, replica_scales, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    sw = torch.zeros((K - 1, n_chains), **f32)
    x = [x_t[k * d:(k + 1) * d] for k in range(K)]
    el = [ell[k:k + 1] for k in range(K)]
    P = (d + 1) // 2
    W = K * (2 * P + 1) + K - 1
    s0 = K * (2 * P + 1)
    n_steps = burn + n_samples * thin
    chunk = noise_chunk(n_chains, W)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, iteration_offset + 1 + t0, n, n_chains, W, dev)
        z = torch.stack([box_muller(u[..., k * (2 * P + 1):], d) for k in range(K)], 1)
        logu = torch.log(torch.stack([u[..., k * (2 * P + 1) + 2 * P] for k in range(K)], 1))
        logu_swap = torch.log(u[..., s0:s0 + K - 1]).permute(0, 2, 1)
        for t in range(n):
            moved, swaps = tempering_step(x, el, z[t], logu[t], logu_swap[t], b, db, sc, tile_fn,
                                          consts)
            for k, m in enumerate(swaps):
                sw[k:k + 1] += m.to(torch.float32)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x[0], el[0], moved[0].to(torch.float32)
    return samples, lps, accs, torch.cat(x), torch.cat(el), sw


@traced("kernel.tempering")
def fused_tempering_sample(
    tile_fn: Callable, cuda_density: Optional[str], x_t: torch.Tensor, ell: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, betas, scale, replica_scales=None,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned replica exchange (≙
    pallas_tempering.py::fused_tempering_sample): ``x_t`` ``(K·d, C)``, the
    raw ℓ ``(K, C)``, ``scale`` the base random-walk scale (scalar or
    ``(d,)``), ``replica_scales`` its factor per temperature (default ones).
    Returns the cold replica's samples ``(n_samples, d, C)``, lps and
    accepted ``(n_samples, 1, C)``, then the final ladder ``(K·d, C)``, its
    ℓ ``(K, C)`` and this call's swap accepts ``(K−1, C)`` (float32)."""
    if x_t.ndim != 2 or x_t.dtype != torch.float32 or ell.ndim != 2:
        raise ValueError("x_t must be a float32 (K*d, C) tensor and ell (K, C)")
    K, n_chains = ell.shape
    if x_t.shape[1] != n_chains or x_t.shape[0] % K or ell.dtype != torch.float32:
        raise ValueError(f"x_t {tuple(x_t.shape)} and ell {tuple(ell.shape)} do not make a ladder")
    d = x_t.shape[0] // K
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (ell, *consts):
        if t.device != x_t.device:
            raise ValueError("x_t, ell and consts must be on one device")
    b, db, sc = ladder_constants(betas, scale, d, replica_scales, x_t.device)
    kw = dict(betas=betas, scale=scale, replica_scales=replica_scales, burn=burn, thin=thin,
              n_samples=n_samples, iteration_offset=iteration_offset)
    if x_t.device.type == "cpu":
        return tempering_sample_reference(tile_fn, cuda_density, x_t, ell, consts, seed, **kw)
    _build.check_cuda_launch(x_t, seed, iteration_offset)
    x, el = x_t.contiguous(), ell.contiguous()
    flat, n_consts = _build.flat_consts(consts, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    x_f, ell_f = torch.empty_like(x), torch.empty_like(el)
    sw = torch.empty((K - 1, n_chains), **f32)
    _build.launch("amh_tempering_sample", "tempering", cuda_density, d, x.device, x, el, b, db,
                  sc, flat, n_consts, K, seed, burn, thin, n_samples, iteration_offset,
                  n_chains, samples, lps, accs, x_f, ell_f, sw)
    fused_tempering_sample.launches += 1
    return samples, lps, accs, x_f, ell_f, sw


fused_tempering_sample.launches = 0
