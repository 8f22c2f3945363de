"""Fused preconditioned Crank-Nicolson: the CUDA kernel's wrapper and its
plain version.

≙ advancedmh_tpu/ops/pallas_pcn.py. The kernel (``csrc/pcn.cu``) is the RWMH
sampling kernel with the state contracted toward the prior mean m: for the
prior N(m, Σ) and the model's log-likelihood ℓ,

    x' = (m + ρ·(x − m)) + β·(L z)   (L z in IEEE float32, or σ ⊙ z),
    accept iff log u < ℓ(x') − ℓ(x),

with ρ = √(1 − β²) rounded once from float64. Sample k is the state after
``burn + (k+1)*thin`` steps. The noise of a step is RWMH's
(ops/rwmh.py::step_noise): d normals and one uniform of absolute step j,
each step from its own counter (the TPU kernel pairs two steps' normals
from one Box-Muller draw, a layout choice not carried over).

Layout: chains on the last axis, params ``(d, C)``, lp ``(1, C)``; ``loc``
``(d,)``, ``scale`` ``(d,)`` or the lower Cholesky factor ``(d, d)``. The
kernel runs a chain on 8 lanes, coordinate i on lane i mod 8, 16 chains a
128-thread block, with ESS's prior draw (``csrc/gp_group.cuh``);
:func:`pcn_launch_info` reports the shape. The wrapper runs the plain
version for tensors on the CPU, and for CUDA tensors launches the kernel or
raises; ``fused_pcn_sample.launches`` counts the launches.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .ess import check_prior_step, prior_args
from .rwmh import _noise_chunk, _perturb, check_cuda_launch, flat_consts, step_noise


def pcn_constants(beta: float) -> Tuple[float, float]:
    """(ρ, β) = (√(1 − β²), β), each rounded once to float32."""
    b = float(beta)
    if not 0.0 < b <= 1.0:
        raise ValueError(f"beta must be in (0, 1], got {beta}")
    return float(np.float32(math.sqrt(1.0 - b * b))), float(np.float32(b))


def pcn_step(x, lp, z, logu, mu, scale, tril, rho: float, beta: float, tile_fn, consts):
    """One pCN step on the chain block (the kernel's arithmetic); ``mu``
    (d, 1). Returns (x, lp, accepted)."""
    cand = (mu + rho * (x - mu)) + beta * _perturb(scale, tril, z)
    lp_c = tile_fn(cand, *consts)
    accept = logu[None] < lp_c - lp
    return torch.where(accept, cand, x), torch.where(accept, lp_c, lp), accept


def pcn_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, loc, scale, consts: Sequence[torch.Tensor], seed: int, *,
    beta: float, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_pcn_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    mu, scale_arr, tril = prior_args(params_t, loc, scale)
    rho, b = pcn_constants(beta)
    x, l = params_t, lp
    n_steps = burn + n_samples * thin
    chunk = _noise_chunk(n_chains, d + 2)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        z, logu = step_noise(seed, iteration_offset + 1 + t0, n, n_chains, d, params_t.device)
        for t in range(n):
            x, l, acc = pcn_step(x, l, z[t], logu[t], mu[:, None], scale_arr, tril, rho, b,
                                 tile_fn, consts)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs


def fused_pcn_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, loc, scale, consts: Sequence[torch.Tensor], seed: int, *,
    beta: float, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned pCN draws (≙ pallas_pcn.py::fused_pcn_sample).
    ``tile_fn`` is the log-likelihood's tile form and ``lp`` its value at
    ``params_t``. Returns samples ``(n_samples, d, C)``, lps and accepted
    ``(n_samples, 1, C)`` (float32 0/1)."""
    check_prior_step(params_t, lp, consts, burn, thin, n_samples)
    rho, b = pcn_constants(beta)
    kw = dict(beta=beta, burn=burn, thin=thin, n_samples=n_samples,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return pcn_sample_reference(tile_fn, cuda_density, params_t, lp, loc, scale, consts,
                                    seed, **kw)
    check_cuda_launch(params_t, seed, iteration_offset)
    mu, scale_arr, tril = prior_args(params_t, loc, scale)
    lib = _build.library()
    p, l = params_t.contiguous(), lp.contiguous()
    d, n_chains = p.shape
    flat, n_consts = flat_consts(consts, p.device)
    # raises before a launch the card would refuse
    pcn_launch_info(cuda_density, d, tril, n_consts, n_chains)
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    with torch.cuda.device(p.device):
        code = lib.amh_pcn_sample(
            _build.density_arg(cuda_density), d, int(tril), p.data_ptr(), l.data_ptr(),
            mu.data_ptr(), scale_arr.data_ptr(), flat.data_ptr(), n_consts, rho, b, seed,
            burn, thin, n_samples, iteration_offset, n_chains, samples.data_ptr(),
            lps.data_ptr(), accs.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(lib, code, "pcn", cuda_density, d)
    fused_pcn_sample.launches += 1
    return samples, lps, accs


fused_pcn_sample.launches = 0


def pcn_launch_info(cuda_density: str, d: int, tril: bool, n_consts: int,
                    n_chains: int) -> dict:
    """:func:`~._build.launch_info` of the kernel with a lower-triangular
    (``tril``) or a diagonal prior scale."""
    return _build.launch_info("amh_pcn_info", "pcn", cuda_density, d, n_consts, n_chains,
                              int(tril))
