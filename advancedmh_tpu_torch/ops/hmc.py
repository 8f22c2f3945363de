"""Fused HMC: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_hmc.py. The kernel (``csrc/hmc.cu``) runs
burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. A step draws the momentum ``p = z/√M⁻¹`` from
the d normals of the step's noise (ops/rwmh.py::step_noise), runs
``n_leapfrog`` kick-drift-kick leapfrog steps

    p += (ε/2)·g,  x += (ε·M⁻¹)·p,  (lp, g) = value_and_grad(x),  p += (ε/2)·g,

and accepts iff ``-log u > -logα`` with the exact energy error
``logα = (lp_y − K(p₁)) − (lp − K(p₀))``, ``K(p) = ½·Σ p²·M⁻¹`` summed over
the coordinates in order. A NaN logα rejects. The diagonal inverse mass is
one ``(d, 1)`` column for every chain (a per-chain ``(d, C)`` block in the
adaptive kernel, ops/hmc_adapt.py, which shares :func:`hmc_step`).

Layout: chains on the last axis, params and gradient ``(d, C)``, lp
``(1, C)``. On the logistic regression the kernel spreads each chain over 8
threads (``csrc/group.cuh``), 16 chains a block, as do ChEES's frozen phase
and AdaptiveHMC; :func:`hmc_launch_info` reports the shape and occupancy. The
wrapper runs the plain version for tensors on the CPU, and for CUDA tensors
launches the kernel or raises; ``fused_hmc_sample.launches`` counts the
launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import _build
from .rwmh import _noise_chunk, check_cuda_launch, flat_consts, row_sum, step_noise


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (a kernel argument)."""
    return float(np.float32(v))


def kinetic(p: torch.Tensor, minv: torch.Tensor) -> torch.Tensor:
    """½·Σ_i p_i²·M⁻¹_i (1, C), summed in coordinate order."""
    return row_sum(p * p * minv) * 0.5


def hmc_propose(x, lp, g, z, eps, minv, n_leapfrog: int, value_and_grad, consts):
    """The proposal of an HMC step (csrc/hmc.cuh::hmc_propose): momentum
    ``z/√M⁻¹``, ``n_leapfrog`` leapfrog steps. Returns the end point
    (y, p₁, lp_y, g_y) and logα."""
    half = 0.5 * eps
    em = eps * minv
    p = z / torch.sqrt(minv)
    k0 = kinetic(p, minv)
    y, g_y, lp_y = x, g, lp
    for _ in range(n_leapfrog):
        p = p + half * g_y
        y = y + em * p
        lp_y, g_y = value_and_grad(y, *consts)
        p = p + half * g_y
    return y, p, lp_y, g_y, (lp_y - kinetic(p, minv)) - (lp - k0)


def hmc_step(x, lp, g, z, logu, eps, minv, n_leapfrog: int, value_and_grad, consts):
    """One endpoint HMC step on the chain block (the kernel's arithmetic).

    ``eps`` is a float or a per-chain (1, C) row, ``minv`` a (d, 1) column or
    a (d, C) block. Returns (x, lp, g, accepted)."""
    y, _, lp_y, g_y, logalpha = hmc_propose(x, lp, g, z, eps, minv, n_leapfrog,
                                            value_and_grad, consts)
    accept = -logu[None] > -logalpha
    return (torch.where(accept, y, x), torch.where(accept, lp_y, lp),
            torch.where(accept, g_y, g), accept)


def minv_column(inverse_mass, d: int, device) -> torch.Tensor:
    """A scalar, ``(d,)`` or ``None`` inverse mass as the kernel's (d, 1)
    float32 column."""
    if inverse_mass is None:
        return torch.ones((d, 1), dtype=torch.float32, device=device)
    m = torch.as_tensor(inverse_mass, dtype=torch.float32).to(device).reshape(-1, 1)
    if m.shape[0] not in (1, d):
        raise ValueError(f"inverse_mass must be a scalar or length {d}")
    return m.expand(d, 1).contiguous()


def hmc_sample_reference(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, step_size: float,
    n_leapfrog: int, inverse_mass: torch.Tensor, burn: int, thin: int,
    n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_hmc_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f)
    lps = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    eps = f32(step_size)
    x, l, g = params_t, lp, grad
    n_steps = burn + n_samples * thin
    chunk = _noise_chunk(n_chains)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        z, logu = step_noise(seed, iteration_offset + 1 + t0, n, n_chains, d, params_t.device)
        for t in range(n):
            x, l, g, acc = hmc_step(x, l, g, z[t], logu[t], eps, inverse_mass,
                                    n_leapfrog, value_and_grad, consts)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, g


def check_hmc_args(params_t, lp, grad, consts, counts, n_leapfrog):
    """Shapes, devices and counts both HMC wrappers check."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    d, n_chains = params_t.shape
    if tuple(lp.shape) != (1, n_chains) or tuple(grad.shape) != (d, n_chains):
        raise ValueError(f"lp must be (1, {n_chains}) and grad ({d}, {n_chains})")
    if min(counts) < 0 or n_leapfrog < 1:
        raise ValueError("burn/warmup >= 0, thin >= 1, n_samples >= 1 and "
                         "n_leapfrog >= 1 are required")
    for t in (lp, grad, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp, grad and consts must be on one device")


def fused_hmc_sample(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, step_size: float,
    n_leapfrog: int, inverse_mass: torch.Tensor, burn: int, thin: int,
    n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned fixed-ε HMC (≙ pallas_hmc.py::fused_hmc_sample).

    ``value_and_grad(p (d, C), *consts) -> (lp (1, C), grad (d, C))`` is the
    model's plain tile value-and-gradient; the kernel uses the CUDA density
    named ``cuda_density``. ``inverse_mass`` is the (d, 1) column
    (:func:`minv_column`). Returns samples ``(n_samples, d, C)``, lps and
    accepted ``(n_samples, 1, C)`` (float32 0/1) and the gradient ``(d, C)``
    at the last state."""
    check_hmc_args(params_t, lp, grad, consts, (burn, thin - 1, n_samples - 1), n_leapfrog)
    d, n_chains = params_t.shape
    if tuple(inverse_mass.shape) != (d, 1) or inverse_mass.device != params_t.device:
        raise ValueError(f"inverse_mass must be a ({d}, 1) column on the params' device")
    if not step_size > 0:
        raise ValueError(f"step_size must be positive, got {step_size}")
    kw = dict(step_size=step_size, n_leapfrog=n_leapfrog, inverse_mass=inverse_mass,
              burn=burn, thin=thin, n_samples=n_samples, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return hmc_sample_reference(value_and_grad, cuda_density, params_t, lp, grad,
                                    consts, seed, **kw)
    check_cuda_launch(params_t, seed, iteration_offset)
    lib = _build.library()
    p, l, g = params_t.contiguous(), lp.contiguous(), grad.contiguous()
    m = inverse_mass.to(torch.float32).contiguous()
    flat, n_consts = flat_consts(consts, p.device)
    f = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f)
    lps = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    g_state = torch.empty((d, n_chains), **f)
    with torch.cuda.device(p.device):
        code = lib.amh_hmc_sample(
            _build.density_arg(cuda_density), d, p.data_ptr(), l.data_ptr(), g.data_ptr(),
            m.data_ptr(), flat.data_ptr(), n_consts, f32(step_size), n_leapfrog, seed,
            burn, thin, n_samples, iteration_offset, n_chains, samples.data_ptr(),
            lps.data_ptr(), accs.data_ptr(), g_state.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    _build.check(lib, code, "hmc", cuda_density, d)
    fused_hmc_sample.launches += 1
    return samples, lps, accs, g_state


fused_hmc_sample.launches = 0


def hmc_launch_info(cuda_density: str, d: int, n_consts: int, n_chains: int) -> dict:
    """:func:`~._build.launch_info` of the HMC kernel."""
    return _build.launch_info("amh_hmc_info", "hmc", cuda_density, d, n_consts, n_chains)
