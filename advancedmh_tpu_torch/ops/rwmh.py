"""Fused random-walk Metropolis: the CUDA kernels' wrappers and plain versions.

≙ advancedmh_tpu/ops/pallas_mh.py. Two kernels, in ``csrc/rwmh.cu``:

- ``fused_rwmh_sample`` (≙ ``_rwmh_sampling_kernel``): burn-in, then
  ``n_samples`` thinned draws; sample k is the state after
  ``burn + (k+1)*thin`` steps.
- ``fused_rwmh`` (≙ ``_rwmh_kernel``): ``n_steps`` steps with no emission;
  returns the final params, lp and accept counts. Any ``n_steps`` works.

Layout as in the JAX kernels: chains on the last axis, params ``(d, C)``,
lp ``(1, C)``. The scale is ``(d,)`` per dimension (or a scalar) or a
``(d, d)`` lower Cholesky factor.

The noise of a step depends only on (seed, j, chain), j the absolute step
(``ops/common.py::step_noise``): ``rwmh_sample_reference`` and
``rwmh_reference`` draw the same normals and uniforms as the kernels, up to
the last ulp of log / sin / cos.

The kernels run the flagship (``cuda_density`` ``"gaussian_mean_scale"``)
on a group of lanes a chain where its observations fit the lanes' registers,
and every other density one thread a chain; ``csrc/rwmh.cu`` alone decides
(:func:`rwmh_launch_info` reports its choice). The group's lanes sum the
observations in another order than the plain versions' tile density, so the
two differ in the last bits of lp, as CUDA's logf differs from PyTorch's.

Each public wrapper runs its plain version for tensors on the CPU, and for
CUDA tensors launches its kernel or raises. ``<wrapper>.launches`` counts
the kernel launches, ``<wrapper>.group_launches`` those the kernels made in
the group form.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from ..utils.trace import traced
from . import _build
from .common import (check_block, noise_chunk, perturb, rw_launch_args, scale_block,
                     step_noise)


# ---- the plain step --------------------------------------------------------


def rwmh_step(x, lp, z, logu, scale, tril, tile_fn, consts):
    """One RWMH step on the chain block: accept iff log(u) < lp_cand − lp."""
    cand = x + perturb(scale, tril, z)
    lp_cand = tile_fn(cand, *consts)
    accept = logu[None] < lp_cand - lp
    return torch.where(accept, cand, x), torch.where(accept, lp_cand, lp), accept


def _run_plain(tile_fn, params_t, lp, scale, consts, seed, n_steps, offset, on_step):
    d, n_chains = params_t.shape
    scale_arr, tril = scale_block(scale, d, params_t.device)
    x, l = params_t, lp
    chunk = noise_chunk(n_chains)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        z, logu = step_noise(seed, offset + 1 + t0, n, n_chains, d, params_t.device)
        for t in range(n):
            x, l, acc = rwmh_step(x, l, z[t], logu[t], scale_arr, tril, tile_fn, consts)
            on_step(t0 + t + 1, x, l, acc)
    return x, l


def rwmh_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the sampling kernel (same signature and
    outputs as :func:`fused_rwmh_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)

    def on_step(s, x, l, acc):
        if s > burn and (s - burn) % thin == 0:
            e = (s - burn) // thin - 1
            samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)

    _run_plain(tile_fn, params_t, lp, scale, consts, seed,
               burn + n_samples * thin, iteration_offset, on_step)
    return samples, lps, accs


def rwmh_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    n_steps: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the throughput kernel (same signature and
    outputs as :func:`fused_rwmh`)."""
    counts = torch.zeros_like(lp)

    def on_step(s, x, l, acc):
        counts.add_(acc.to(torch.float32))

    x, l = _run_plain(tile_fn, params_t, lp, scale, consts, seed, n_steps,
                      iteration_offset, on_step)
    return x, l, counts


# ---- wrappers ---------------------------------------------------------------


@traced("kernel.rwmh_sample")
def fused_rwmh_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned emission (≙ pallas_mh.py::fused_rwmh_sample).

    Returns samples ``(n_samples, d, C)``, lps ``(n_samples, 1, C)`` and
    accepted ``(n_samples, 1, C)`` (float32 0/1, the decision of the last
    step before each sample)."""
    check_block(params_t, lp, consts, (burn, thin - 1, n_samples - 1))
    if params_t.device.type == "cpu":
        return rwmh_sample_reference(
            tile_fn, cuda_density, params_t, lp, scale, consts, seed, burn=burn,
            thin=thin, n_samples=n_samples, iteration_offset=iteration_offset,
        )
    tril, p, l, s, flat, n_consts = rw_launch_args(params_t, lp, scale, consts, seed,
                                                   iteration_offset)
    d, n_chains = p.shape
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    lanes = ctypes.c_int32(0)  # the lanes a chain the kernel launched with
    _build.launch("amh_rwmh_sample", "rwmh", cuda_density, d, p.device, int(tril), p, l, s,
                  flat, n_consts, seed, burn, thin, n_samples, iteration_offset, n_chains,
                  samples, lps, accs, ctypes.addressof(lanes))
    fused_rwmh_sample.launches += 1
    fused_rwmh_sample.group_launches += int(lanes.value > 1)
    return samples, lps, accs


@traced("kernel.rwmh")
def fused_rwmh(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    n_steps: int, iteration_offset: int = 0,
):
    """``n_steps`` RWMH steps in one launch (≙ pallas_mh.py::fused_rwmh).

    Returns params ``(d, C)``, lp ``(1, C)`` and accept counts ``(1, C)``."""
    check_block(params_t, lp, consts, (n_steps,))
    if params_t.device.type == "cpu":
        return rwmh_reference(
            tile_fn, cuda_density, params_t, lp, scale, consts, seed,
            n_steps=n_steps, iteration_offset=iteration_offset,
        )
    tril, p, l, s, flat, n_consts = rw_launch_args(params_t, lp, scale, consts, seed,
                                                   iteration_offset)
    d, n_chains = p.shape
    out_p, out_l, out_a = torch.empty_like(p), torch.empty_like(l), torch.empty_like(l)
    lanes = ctypes.c_int32(0)  # the lanes a chain the kernel launched with
    _build.launch("amh_rwmh", "rwmh", cuda_density, d, p.device, int(tril), p, l, s, flat,
                  n_consts, seed, n_steps, iteration_offset, n_chains, out_p, out_l, out_a,
                  ctypes.addressof(lanes))
    fused_rwmh.launches += 1
    fused_rwmh.group_launches += int(lanes.value > 1)
    return out_p, out_l, out_a


def rwmh_launch_info(cuda_density: str, d: int, tril: bool, n_consts: int,
                     n_chains: int) -> dict:
    """:func:`~._build.launch_info` of the sampling kernel in the form it
    takes for these arguments (the throughput kernel takes the same), with
    its ``registers`` a thread; ``lanes_per_chain`` above 1 is the group
    form."""
    return _build.launch_info("amh_rwmh_info", "rwmh", cuda_density, d, n_consts, n_chains,
                              int(tril))


fused_rwmh_sample.launches = fused_rwmh_sample.group_launches = 0
fused_rwmh.launches = fused_rwmh.group_launches = 0
