"""Fused Barker proposal: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_barker.py. The kernel (``csrc/barker.cu``) runs
burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. A step (Livingstone & Zanella 2022) draws
z = σ·N(0, 1) per coordinate and keeps its sign with the logistic
probability σ(z·g), g the gradient carried from the last accepted state,
written as the logit test ``log u − log(1 − u) < z·g``:

    δ = ±z,  y = x + δ,  (lp_y, g_y) = value_and_grad(y),
    logα = (lp_y − lp) + Σ_i [softplus(−δ_i·g_i) − softplus(δ_i·g_y,i)],

summed over the coordinates in order, accepted iff ``−log u > −logα``.

Noise of absolute step j of a chain (csrc/common.cuh::StepWords): the d
normals' Box-Muller words 0 .. 2P−1, the d sign uniforms at words 2P ..
2P+d−1, the accept uniform at word 2P+d. Layout: chains on the last axis,
params and gradient ``(d, C)``, lp ``(1, C)``. On the logistic regression
the kernel runs a chain on 8 lanes, 16 chains a 128-thread block (the group
step of ``csrc/hmc_group.cuh``); :func:`barker_launch_info` reports the
shape. The wrapper runs the plain version for tensors on the CPU, and for
CUDA tensors launches the kernel or raises; ``fused_barker_sample.launches``
counts the launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import _build
from .rwmh import (_noise_chunk, box_muller, check_cuda_launch, flat_consts, philox_uniforms,
                   row_sum, softplus)


def barker_step(x, lp, g, normals, u_sign, logu, sigma: float, value_and_grad, consts):
    """One Barker step on the chain block (the kernel's arithmetic); returns
    (x, lp, g, accepted)."""
    z = sigma * normals
    keep = torch.log(u_sign) - torch.log(1.0 - u_sign) < z * g
    delta = torch.where(keep, z, -z)
    y = x + delta
    lp_y, g_y = value_and_grad(y, *consts)
    logalpha = (lp_y - lp) + row_sum(softplus(-delta * g) - softplus(delta * g_y))
    accept = -logu[None] > -logalpha
    return (torch.where(accept, y, x), torch.where(accept, lp_y, lp),
            torch.where(accept, g_y, g), accept)


def barker_sample_reference(
    value_and_grad: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, grad: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *,
    step_size: float, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_barker_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    sigma = float(np.float32(step_size))
    P = (d + 1) // 2
    n_words = 2 * P + d + 1
    x, l, g = params_t, lp, grad
    n_steps = burn + n_samples * thin
    chunk = _noise_chunk(n_chains, n_words)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, iteration_offset + 1 + t0, n, n_chains, n_words,
                            params_t.device)
        z = box_muller(u, d)
        for t in range(n):
            x, l, g, acc = barker_step(x, l, g, z[t], u[t, :, 2 * P:2 * P + d].T,
                                       torch.log(u[t, :, 2 * P + d]), sigma,
                                       value_and_grad, consts)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, g


def fused_barker_sample(
    value_and_grad: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, grad: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *,
    step_size: float, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned Barker draws (≙ pallas_barker.py::fused_barker_sample).

    ``value_and_grad(p (d, C), *consts) -> (lp (1, C), grad (d, C))`` is the
    model's plain tile value-and-gradient; the kernel uses the CUDA density
    named ``cuda_density``. Returns samples ``(n_samples, d, C)``, lps and
    accepted ``(n_samples, 1, C)`` (float32 0/1) and the gradient ``(d, C)``
    at the last state."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    d, n_chains = params_t.shape
    if tuple(lp.shape) != (1, n_chains) or tuple(grad.shape) != (d, n_chains):
        raise ValueError(f"lp must be (1, {n_chains}) and grad ({d}, {n_chains})")
    if not step_size > 0:
        raise ValueError(f"step_size must be positive, got {step_size}")
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, grad, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp, grad and consts must be on one device")
    kw = dict(step_size=step_size, burn=burn, thin=thin, n_samples=n_samples,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return barker_sample_reference(value_and_grad, cuda_density, params_t, lp, grad,
                                       consts, seed, **kw)
    check_cuda_launch(params_t, seed, iteration_offset)
    lib = _build.library()
    p, l, g = params_t.contiguous(), lp.contiguous(), grad.contiguous()
    flat, n_consts = flat_consts(consts, p.device)
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    out_grad = torch.empty((d, n_chains), **f32)
    with torch.cuda.device(p.device):
        code = lib.amh_barker_sample(
            _build.density_arg(cuda_density), d, p.data_ptr(), l.data_ptr(), g.data_ptr(),
            flat.data_ptr(), n_consts, float(np.float32(step_size)), seed, burn, thin,
            n_samples, iteration_offset, n_chains, samples.data_ptr(), lps.data_ptr(),
            accs.data_ptr(), out_grad.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(lib, code, "barker", cuda_density, d)
    fused_barker_sample.launches += 1
    return samples, lps, accs, out_grad


fused_barker_sample.launches = 0


def barker_launch_info(cuda_density: str, d: int, n_consts: int, n_chains: int) -> dict:
    """:func:`~._build.launch_info` of the kernel."""
    return _build.launch_info("amh_barker_info", "barker", cuda_density, d, n_consts, n_chains)
