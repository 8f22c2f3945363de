"""Fused Multiple-Try Metropolis: the CUDA kernels' wrappers and plain versions.

≙ advancedmh_tpu/ops/pallas_mtm.py. Two kernels, in ``csrc/mtm.cu``:

- ``fused_mtm_sample`` (≙ ``_mtm_sampling_kernel``): burn-in, then
  ``n_samples`` thinned draws; sample e is the state after
  ``burn + (e+1)*thin`` steps.
- ``fused_mtm`` (≙ ``_mtm_kernel``): ``n_steps`` steps with no emission;
  returns the final params, lp and accept counts.

A step of k tries from x draws k candidates, selects one by a streaming
Gumbel-argmax over lp + g (strict ``>``: the first index wins a tie), draws
k − 1 references around the winner and accepts with

    log α = logsumexp(lp(y₁..y_k)) − logsumexp(lp(r₁..r_{k−1}), lp(x)),

both logsumexps streamed (:func:`streaming_logsumexp`) over densities
clamped at −1e30 with a NaN-keeping max, as the Pallas kernel clamps them.
So a step whose current state, candidates and references all sit at −1e30
has log α = 0 and accepts; the torch engine (XLA's unclamped logsumexp)
gets NaN there and rejects.

Noise of absolute step j of a chain (csrc/common.cuh::StepWords,
P = ⌈d/2⌉ Box-Muller pairs): candidate i reads its normals from words
i(2P+1) .. i(2P+1)+2P−1 and its Gumbel uniform from word i(2P+1)+2P;
reference r reads k(2P+1)+2Pr .. +2P−1; the accept uniform is word
k(2P+1)+2P(k−1).

Layout as in the JAX kernels: chains on the last axis, params ``(d, C)``,
lp ``(1, C)``; the scale is ``(d,)`` (or a scalar) or a ``(d, d)`` lower
Cholesky factor. Each wrapper runs its plain version for tensors on the
CPU, and for CUDA tensors launches its kernel or raises;
``<wrapper>.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils.trace import traced
from . import _build
from .common import (box_muller, check_block, noise_chunk, perturb, philox_uniforms,
                     rw_launch_args, scale_block)

NEG_CLAMP = -1.0e30


def mtm_words(d: int, k: int) -> int:
    """Philox words one chain-step of k tries reads."""
    P = (d + 1) // 2
    return k * (2 * P + 1) + 2 * P * (k - 1) + 1


def _clamp(lp: torch.Tensor) -> torch.Tensor:
    """max(lp, −1e30), NaN kept (jnp.maximum; csrc/common.cuh::nan_max)."""
    return torch.maximum(lp, torch.full_like(lp, NEG_CLAMP))


def streaming_logsumexp(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernels' logsumexp over a sequence of equal-shape tensors: each
    clamped at −1e30, then a running (max, scaled sum) pair,
    ``m' = max(m, v)``, ``s' = s·exp(m − m') + exp(v − m')``, and
    ``m + log s`` at the end."""
    m = _clamp(values[0])
    s = torch.ones_like(m)
    for v in values[1:]:
        v = _clamp(v)
        m_new = torch.maximum(m, v)
        s = s * torch.exp(m - m_new) + torch.exp(v - m_new)
        m = m_new
    return m + torch.log(s)


def mtm_step(x, lp, z_cand, u_gumbel, z_ref, logu, scale, tril, tile_fn, consts):
    """One MTM step on the chain block with its noise: candidate normals
    ``(k, d, C)``, Gumbel uniforms ``(k, C)``, reference normals
    ``(k − 1, d, C)`` and ``log u`` ``(C,)``. Returns (x, lp, accepted)."""
    k = z_cand.shape[0]
    best = best_lp = best_score = None
    cand_lps = []
    for i in range(k):
        y = x + perturb(scale, tril, z_cand[i])
        lp_y = _clamp(tile_fn(y, *consts))
        score = lp_y + -torch.log(-torch.log(u_gumbel[i:i + 1]))
        if i == 0:
            best, best_lp, best_score = y, lp_y, score
        else:
            sel = score > best_score
            best_score = torch.where(sel, score, best_score)
            best_lp = torch.where(sel, lp_y, best_lp)
            best = torch.where(sel, y, best)
        cand_lps.append(lp_y)
    ref_lps = [lp] + [tile_fn(best + perturb(scale, tril, z_ref[r]), *consts)
                      for r in range(k - 1)]
    logalpha = streaming_logsumexp(cand_lps) - streaming_logsumexp(ref_lps)
    accept = logu[None] < logalpha
    return torch.where(accept, best, x), torch.where(accept, best_lp, lp), accept


def _run_plain(tile_fn, params_t, lp, scale, consts, seed, k, n_steps, offset, on_step):
    d, n_chains = params_t.shape
    dev = params_t.device
    scale_arr, tril = scale_block(scale, d, dev)
    P = (d + 1) // 2
    W = mtm_words(d, k)
    r0 = k * (2 * P + 1)
    x, l = params_t, lp
    chunk = noise_chunk(n_chains, W)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, offset + 1 + t0, n, n_chains, W, dev)
        z_cand = torch.stack([box_muller(u[..., i * (2 * P + 1):], d) for i in range(k)], 1)
        u_gumbel = torch.stack([u[..., i * (2 * P + 1) + 2 * P] for i in range(k)], 1)
        z_ref = [box_muller(u[..., r0 + 2 * P * r:], d) for r in range(k - 1)]
        logu = torch.log(u[..., W - 1])
        for t in range(n):
            x, l, acc = mtm_step(x, l, z_cand[t], u_gumbel[t], [z[t] for z in z_ref], logu[t],
                                 scale_arr, tril, tile_fn, consts)
            on_step(t0 + t + 1, x, l, acc)
    return x, l


def mtm_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    k: int, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the sampling kernel (same signature and
    outputs as :func:`fused_mtm_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)

    def on_step(s, x, l, acc):
        if s > burn and (s - burn) % thin == 0:
            e = (s - burn) // thin - 1
            samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)

    _run_plain(tile_fn, params_t, lp, scale, consts, seed, k, burn + n_samples * thin,
               iteration_offset, on_step)
    return samples, lps, accs


def mtm_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    k: int, n_steps: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the throughput kernel (same signature and
    outputs as :func:`fused_mtm`)."""
    counts = torch.zeros_like(lp)

    def on_step(s, x, l, acc):
        counts.add_(acc.to(torch.float32))

    x, l = _run_plain(tile_fn, params_t, lp, scale, consts, seed, k, n_steps,
                      iteration_offset, on_step)
    return x, l, counts


def _check_k(k) -> int:
    if int(k) != k or int(k) < 1:
        raise ValueError(f"k must be an integer >= 1, got {k}")
    return int(k)


@traced("kernel.mtm_sample")
def fused_mtm_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    k: int, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned emission of k-try MTM (≙
    pallas_mtm.py::fused_mtm_sample). Returns samples ``(n_samples, d, C)``,
    lps and accepted ``(n_samples, 1, C)`` (float32 0/1)."""
    check_block(params_t, lp, consts, (burn, thin - 1, n_samples - 1))
    k = _check_k(k)
    kw = dict(k=k, burn=burn, thin=thin, n_samples=n_samples, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return mtm_sample_reference(tile_fn, cuda_density, params_t, lp, scale, consts, seed,
                                    **kw)
    tril, p, l, s, flat, n_consts = rw_launch_args(params_t, lp, scale, consts, seed,
                                                   iteration_offset)
    d, n_chains = p.shape
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    _build.launch("amh_mtm_sample", "mtm", cuda_density, d, p.device, int(tril), p, l, s, flat,
                  n_consts, k, seed, burn, thin, n_samples, iteration_offset, n_chains, samples,
                  lps, accs)
    fused_mtm_sample.launches += 1
    return samples, lps, accs


@traced("kernel.mtm")
def fused_mtm(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    k: int, n_steps: int, iteration_offset: int = 0,
):
    """``n_steps`` k-try MTM steps in one launch (≙ pallas_mtm.py::fused_mtm).
    Returns params ``(d, C)``, lp ``(1, C)`` and accept counts ``(1, C)``."""
    check_block(params_t, lp, consts, (n_steps,))
    k = _check_k(k)
    if params_t.device.type == "cpu":
        return mtm_reference(tile_fn, cuda_density, params_t, lp, scale, consts, seed, k=k,
                             n_steps=n_steps, iteration_offset=iteration_offset)
    tril, p, l, s, flat, n_consts = rw_launch_args(params_t, lp, scale, consts, seed,
                                                   iteration_offset)
    d, n_chains = p.shape
    out_p, out_l, out_a = torch.empty_like(p), torch.empty_like(l), torch.empty_like(l)
    _build.launch("amh_mtm", "mtm", cuda_density, d, p.device, int(tril), p, l, s, flat,
                  n_consts, k, seed, n_steps, iteration_offset, n_chains, out_p, out_l, out_a)
    fused_mtm.launches += 1
    return out_p, out_l, out_a


fused_mtm_sample.launches = 0
fused_mtm.launches = 0
