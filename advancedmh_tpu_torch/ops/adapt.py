"""Fused dual-averaging RWMH: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_adapt.py. The kernel (``csrc/adapt.cu``) runs
``warmup`` isotropic random-walk steps ``y = x + ε·z`` that adapt each
chain's ε by HG14 dual averaging on the accept indicator (ops/hmc_adapt.py::
dual_average_step), then ``n_samples`` thinned draws at the frozen
``ε̄ = exp(log ε̄)``; sample k is the state after ``warmup + (k+1)*thin``
steps. A step accepts iff ``log u < lp_y − lp``; its noise is RWMH's
(ops/rwmh.py::step_noise), numbered by the absolute step through warmup and
sampling alike.

The resume variant (``log_eps_bar`` given, ``warmup=0``) starts frozen at
the given per-chain log ε̄. Both variants form ε̄ as ``exp`` of the stored
log ε̄, so a run split after its warmup and resumed is bit-exact.

Layout: chains on the last axis, params ``(d, C)``, lp and log ε̄ ``(1, C)``.
The wrapper runs the plain version for tensors on the CPU, and for CUDA
tensors launches the kernel or raises; ``fused_adapt_rwmh_sample.launches``
counts the launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from . import _build
from .hmc_adapt import DualAveraging, dual_average_step
from .rwmh import _check, _noise_chunk, check_cuda_launch, flat_consts, step_noise


def iso_rwmh_step(x, lp, z, logu, eps, tile_fn, consts):
    """One isotropic RWMH step ``y = x + ε·z`` (ε a float or (1, C) row)."""
    y = x + eps * z
    lp_y = tile_fn(y, *consts)
    accept = logu[None] < lp_y - lp
    return torch.where(accept, y, x), torch.where(accept, lp_y, lp), accept


def adapt_rwmh_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, warmup: int,
    thin: int, n_samples: int, da: DualAveraging = DualAveraging(1.0, 0.234),
    log_eps_bar: Optional[torch.Tensor] = None, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_adapt_rwmh_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f)
    lps = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    if log_eps_bar is not None:
        leb, warmup = log_eps_bar, 0
    else:
        log_eps = torch.full((1, n_chains), da.log_eps0, **f)
        leb = log_eps.clone()
        h_bar = torch.zeros((1, n_chains), **f)
    x, l = params_t, lp
    n_steps = warmup + n_samples * thin
    chunk = _noise_chunk(n_chains)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        z, logu = step_noise(seed, iteration_offset + 1 + t0, n, n_chains, d, params_t.device)
        for i in range(n):
            s = t0 + i + 1
            if s <= warmup:
                x, l, acc = iso_rwmh_step(x, l, z[i], logu[i], torch.exp(log_eps),
                                          tile_fn, consts)
                log_eps, leb, h_bar = dual_average_step(s, acc, log_eps, leb, h_bar, da)
                continue
            x, l, acc = iso_rwmh_step(x, l, z[i], logu[i], torch.exp(leb), tile_fn, consts)
            if (s - warmup) % thin == 0:
                e = (s - warmup) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, leb


def fused_adapt_rwmh_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, warmup: int,
    thin: int, n_samples: int, da: DualAveraging = DualAveraging(1.0, 0.234),
    log_eps_bar: Optional[torch.Tensor] = None, iteration_offset: int = 0,
):
    """Dual-averaging warmup + frozen-ε̄ thinned RWMH in one launch
    (≙ pallas_adapt.py::fused_adapt_rwmh_sample). Returns samples
    ``(n_samples, d, C)``, lps and accepted ``(n_samples, 1, C)`` and the
    frozen log ε̄ ``(1, C)``."""
    _check(params_t, lp, consts, (warmup, thin - 1, n_samples - 1))
    d, n_chains = params_t.shape
    if log_eps_bar is not None:
        if warmup != 0:
            raise ValueError("the resume variant runs no warmup (warmup=0)")
        if tuple(log_eps_bar.shape) != (1, n_chains) or log_eps_bar.device != params_t.device:
            raise ValueError(f"log_eps_bar must be (1, {n_chains}) on the params' device")
    kw = dict(warmup=warmup, thin=thin, n_samples=n_samples, da=da,
              log_eps_bar=log_eps_bar, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return adapt_rwmh_reference(tile_fn, cuda_density, params_t, lp, consts, seed, **kw)
    check_cuda_launch(params_t, seed, iteration_offset)
    lib = _build.library()
    p, l = params_t.contiguous(), lp.contiguous()
    flat, n_consts = flat_consts(consts, p.device)
    f = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f)
    lps = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    leb_out = torch.empty((1, n_chains), **f)
    resume = log_eps_bar is not None
    leb_in = log_eps_bar.contiguous() if resume else leb_out
    with torch.cuda.device(p.device):
        code = lib.amh_adapt_rwmh_sample(
            _build.density_arg(cuda_density), d, int(resume), p.data_ptr(), l.data_ptr(),
            leb_in.data_ptr(), flat.data_ptr(), n_consts, *da.args(), seed, warmup, thin,
            n_samples, iteration_offset, n_chains, samples.data_ptr(), lps.data_ptr(),
            accs.data_ptr(), leb_out.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    _build.check(lib, code, "adapt", cuda_density, d)
    fused_adapt_rwmh_sample.launches += 1
    return samples, lps, accs, leb_out


fused_adapt_rwmh_sample.launches = 0
