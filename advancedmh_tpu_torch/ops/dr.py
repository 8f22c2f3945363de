"""Fused delayed rejection: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_dr.py. The kernel (``csrc/dr.cu``) runs
burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. Two zero-mean Gaussian random-walk stages of
per-dimension scales s₁ (bold) and s₂ (timid, symmetric), both densities
evaluated on every step and stage 2 masked in (Mira 2001):

    y₁ = x + s₁z₁,  acc₁ = log U₁ < lp₁ − lp,
    y₂ = x + s₂z₂,
    dq = −½(Σᵢ((y₁ᵢ − y₂ᵢ)·(1/s₁ᵢ))² − Σᵢ z₁ᵢ²)   (q₁'s normalisations cancel),
    la₂ = lp₂ − lp + dq + log1m_exp(lp₁ − lp₂) − log1m_exp(lp₁ − lp),
    acc₂ = log U₂ < la₂ and not acc₁.

Noise of absolute step j of a chain (csrc/common.cuh::StepWords): z₁'s
Box-Muller words 0 .. 2P−1, z₂'s 2P .. 4P−1, U₁ at 4P and U₂ at 4P+1.
Layout: chains on the last axis, params ``(d, C)``, lp ``(1, C)``. The
wrapper runs the plain version for tensors on the CPU, and for CUDA tensors
launches the kernel or raises; ``fused_dr_sample.launches`` counts the
launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils.trace import traced
from . import _build
from .common import box_muller, noise_chunk, philox_uniforms, row_sum, scale_block


def log1m_exp(a: torch.Tensor) -> torch.Tensor:
    """log(1 − eᵃ) for a < 0, floored at −1e30; −1e30 for a ≥ 0 and NaN
    (≙ advancedmh_tpu/samplers/dr.py::_log1m_exp, Mächler 2012's two
    branches). The floor keeps masked lanes from meeting inf − inf."""
    neg = a < 0
    a_s = torch.where(neg, a, torch.full_like(a, -1.0))
    out = torch.where(a_s > -0.693, torch.log(-torch.expm1(a_s)),
                      torch.log1p(-torch.exp(a_s)))
    floor = torch.full_like(out, -1e30)
    return torch.where(neg, torch.maximum(out, floor), floor)


def stage_scales(scale1, scale2, d: int, device):
    """The two stages' per-dimension std-devs ``(d,)`` from scalars or
    length-d scales; a full-covariance stage raises (the q₁ distance would
    need a triangular solve in the kernel)."""
    out = []
    for s in (scale1, scale2):
        arr, tril = scale_block(s, d, device)
        if tril:
            raise ValueError(
                "engine='fused' DR supports scalar/per-dim stage scales; full-covariance "
                "stages need engine='torch' (the q1 cross distance would need an "
                "in-kernel triangular solve).")
        out.append(arr)
    return out


def dr_step(x, lp, z1, z2, logu1, logu2, s1, s2, inv_s1, tile_fn, consts):
    """One delayed-rejection step on the chain block (the kernel's
    arithmetic); ``s1``, ``s2`` and ``inv_s1`` are ``(d, 1)``. Returns (x, lp,
    accepted)."""
    y1 = x + s1 * z1
    y2 = x + s2 * z2
    lp1 = tile_fn(y1, *consts)
    la1 = lp1 - lp
    acc1 = logu1 < la1
    lp2 = tile_fn(y2, *consts)
    d12 = (y1 - y2) * inv_s1
    dq = -0.5 * (row_sum(d12 * d12) - row_sum(z1 * z1))
    la2 = lp2 - lp + dq + log1m_exp(lp1 - lp2) - log1m_exp(la1)
    acc2 = (logu2 < la2) & ~acc1
    x = torch.where(acc1, y1, torch.where(acc2, y2, x))
    lp = torch.where(acc1, lp1, torch.where(acc2, lp2, lp))
    return x, lp, acc1 | acc2


def dr_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale1, scale2, consts: Sequence[torch.Tensor], seed: int, *,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_dr_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    s1, s2 = (s[:, None] for s in stage_scales(scale1, scale2, d, params_t.device))
    inv_s1 = torch.ones_like(s1) / s1
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    P = (d + 1) // 2
    n_words = 4 * P + 2
    x, l = params_t, lp
    n_steps = burn + n_samples * thin
    chunk = noise_chunk(n_chains, n_words)
    for t0 in range(0, n_steps, chunk):
        m = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, iteration_offset + 1 + t0, m, n_chains, n_words,
                            params_t.device)
        z1, z2 = box_muller(u, d), box_muller(u[..., 2 * P:], d)
        logu = torch.log(u[..., 4 * P:])
        for t in range(m):
            x, l, acc = dr_step(x, l, z1[t], z2[t], logu[None, t, :, 0], logu[None, t, :, 1],
                                s1, s2, inv_s1, tile_fn, consts)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs


@traced("kernel.dr")
def fused_dr_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale1, scale2, consts: Sequence[torch.Tensor], seed: int, *,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned delayed rejection (≙ pallas_dr.py::fused_dr_sample);
    ``scale1``/``scale2`` are scalars or length-d std-devs of the bold and
    timid stages. Returns samples ``(n_samples, d, C)``, lps and accepted
    ``(n_samples, 1, C)`` (float32 0/1)."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    d, n_chains = params_t.shape
    if tuple(lp.shape) != (1, n_chains) or lp.dtype != torch.float32:
        raise ValueError(f"lp must be a float32 (1, {n_chains}) tensor")
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp and consts must be on one device")
    s1, s2 = stage_scales(scale1, scale2, d, params_t.device)
    kw = dict(burn=burn, thin=thin, n_samples=n_samples, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return dr_sample_reference(tile_fn, cuda_density, params_t, lp, s1, s2, consts, seed,
                                   **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    p, l = params_t.contiguous(), lp.contiguous()
    flat, n_consts = _build.flat_consts(consts, p.device)
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    _build.launch("amh_dr_sample", "dr", cuda_density, d, p.device, p, l, s1, s2, flat,
                  n_consts, seed, burn, thin, n_samples, iteration_offset, n_chains, samples,
                  lps, accs)
    fused_dr_sample.launches += 1
    return samples, lps, accs


fused_dr_sample.launches = 0
