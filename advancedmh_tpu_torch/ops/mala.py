"""Fused Langevin MALA: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_mala.py. The kernel (``csrc/mala.cu``) runs
burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. A step proposes ``y = x + (s2/2) g + sqrt(s2) z``
with ``g`` the gradient carried from the last accepted state, evaluates the
density's value and gradient at ``y`` once, and accepts iff
``-log u > -logα`` with

    logα = lp_y − lp + (‖y − x − (s2/2) g‖² − ‖x − y − (s2/2) g_y‖²) / (2 s2).

The noise of a step is RWMH's (ops/common.py::step_noise): ``z`` from the d
normals and ``u`` from the one uniform of absolute step j for each chain.

Layout: chains on the last axis, params and gradient ``(d, C)``, lp
``(1, C)``. The wrapper runs the plain version for tensors on the CPU, and
for CUDA tensors launches the kernel or raises; ``fused_mala_sample.launches``
counts the launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.trace import traced
from . import _build
from .common import noise_chunk, row_sum, step_noise


def mala_constants(step_size_sq: float) -> Tuple[float, float, float]:
    """(σ, σ²/2, 1/(2σ²)) rounded to float32, as the JAX kernel forms them."""
    s2 = float(step_size_sq)
    if not s2 > 0:
        raise ValueError(f"step_size_sq must be positive, got {step_size_sq}")
    return (float(np.float32(np.sqrt(s2))), float(np.float32(0.5 * s2)),
            float(np.float32(1.0 / (2.0 * s2))))


def mala_logalpha(x, lp, g, y, lp_y, g_y, half_s2: float, inv_2s2: float):
    """logα of a Langevin proposal x → y (the kernel's arithmetic)."""
    drift_x = x + half_s2 * g
    drift_y = y + half_s2 * g_y
    fwd = row_sum(torch.square(y - drift_x))
    bwd = row_sum(torch.square(x - drift_y))
    return (lp_y - lp) + (fwd - bwd) * inv_2s2


def mala_step(x, lp, g, z, logu, constants, value_and_grad, consts):
    """One MALA step on the chain block; returns (x, lp, g, accepted)."""
    sigma, half_s2, inv_2s2 = constants
    y = (x + half_s2 * g) + sigma * z
    lp_y, g_y = value_and_grad(y, *consts)
    logalpha = mala_logalpha(x, lp, g, y, lp_y, g_y, half_s2, inv_2s2)
    accept = -logu[None] > -logalpha
    return (torch.where(accept, y, x), torch.where(accept, lp_y, lp),
            torch.where(accept, g_y, g), accept)


def mala_sample_reference(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, step_size_sq: float,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_mala_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    constants = mala_constants(step_size_sq)
    x, l, g = params_t, lp, grad
    n_steps = burn + n_samples * thin
    chunk = noise_chunk(n_chains)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        z, logu = step_noise(seed, iteration_offset + 1 + t0, n, n_chains, d,
                             params_t.device)
        for t in range(n):
            x, l, g, acc = mala_step(x, l, g, z[t], logu[t], constants,
                                     value_and_grad, consts)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, g


@traced("kernel.mala")
def fused_mala_sample(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, step_size_sq: float,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned Langevin MALA (≙ pallas_mala.py::fused_mala_sample).

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
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, grad, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp, grad and consts must be on one device")
    kw = dict(step_size_sq=step_size_sq, burn=burn, thin=thin,
              n_samples=n_samples, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return mala_sample_reference(value_and_grad, cuda_density, params_t, lp,
                                     grad, consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    sigma, half_s2, inv_2s2 = mala_constants(step_size_sq)
    p, l, g = params_t.contiguous(), lp.contiguous(), grad.contiguous()
    flat, n_consts = _build.flat_consts(consts, p.device)
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    out_grad = torch.empty((d, n_chains), **f32)
    _build.launch("amh_mala_sample", "mala", cuda_density, d, p.device, p, l, g, flat,
                  n_consts, sigma, half_s2, inv_2s2, seed, burn, thin, n_samples,
                  iteration_offset, n_chains, samples, lps, accs, out_grad)
    fused_mala_sample.launches += 1
    return samples, lps, accs, out_grad


fused_mala_sample.launches = 0
