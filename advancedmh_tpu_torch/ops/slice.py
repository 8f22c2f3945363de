"""Fused slice sampling: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_slice.py. The kernel (``csrc/slice.cu``) runs
burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. A step of Neal's slice sampler along a random
unit direction u:

    log y = lp + log U,   [L, R] = [−w·U₀, −w·U₀ + w],
    stepping out: the budget m is split J = ⌊m·V⌋ left, K = m − 1 − J right;
        each end grows by w while its budget lasts and it lies in the slice,
    shrinkage: t = L + U_k·(R − L); accept x + t·u iff lp(x + t·u) > log y,
        else the rejected t becomes the end on its own side of 0,

for at most ``max_shrink`` trips; a chain that exhausts them keeps its state
and reports accepted = 0. The same deterministic move (:func:`slice_trips`)
is the torch engine's (samplers/slice.py), given its own draws.

The noise of absolute step j of a chain is one Philox stream (see
csrc/common.cuh::StepWords): the d normals' Box-Muller words 0 .. 2P−1, then
U (word 2P), U₀ (2P+1), V (2P+2), then trip k's uniform at word 2P+3+k, so a
trip that a chain never reaches changes nothing. Layout: chains on the last
axis, params ``(d, C)``, lp ``(1, C)``. The wrapper runs the plain version
for tensors on the CPU, and for CUDA tensors launches the kernel or raises;
``fused_slice_sample.launches`` counts the launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils.trace import traced
from . import _build
from .common import box_muller, noise_chunk, philox_uniforms


def slice_trips(x, lp, u_dir, logy, u0, v, trip_u, ld: Callable, width: float,
                max_stepout: int):
    """The deterministic part of a slice step over a batch of B chains.

    ``x`` and the unit direction ``u_dir`` are (B, D), ``lp``, ``logy``,
    ``u0`` and ``v`` (B,), ``trip_u`` the shrink trips' uniforms (S, B) and
    ``ld(points (B, D)) -> (B,)`` the density. Stepping out runs the masked
    alternating loop of ``max_stepout − 1`` trips (an end whose budget is
    spent or that left the slice stops for good), shrinkage up to S masked
    trips; both exit once no chain has work left. Returns (x, lp, done, evals):
    the density evaluations each chain needed (the kernel's count)."""
    w, m = float(width), int(max_stepout)
    L = (-w) * u0
    R = L + w
    J = torch.floor(m * v)
    K = (m - 1.0) - J
    evals = torch.zeros(lp.shape, dtype=torch.int32, device=lp.device)
    at = lambda t: x + t[:, None] * u_dir
    for _ in range(m - 1):
        if not bool(((J > 0.5) | (K > 0.5)).any()):
            break
        act = J > 0.5
        grow = act & (ld(at(L)) > logy)
        evals += act
        L = torch.where(grow, L - w, L)
        J = torch.where(grow, J - 1.0, torch.zeros_like(J))
        act = K > 0.5
        grow = act & (ld(at(R)) > logy)
        evals += act
        R = torch.where(grow, R + w, R)
        K = torch.where(grow, K - 1.0, torch.zeros_like(K))
    done = torch.zeros(lp.shape, dtype=torch.bool, device=lp.device)
    res, res_lp = x, lp
    for i in range(trip_u.shape[0]):
        if bool(done.all()):
            break
        t = L + trip_u[i] * (R - L)
        cand = at(t)
        lp_c = ld(cand)
        evals += ~done
        ok = lp_c > logy  # strict, and False for NaN
        newly = ok & ~done
        res = torch.where(newly[:, None], cand, res)
        res_lp = torch.where(newly, lp_c, res_lp)
        done = done | ok
        running = ~done
        L = torch.where(running & (t < 0), t, L)
        R = torch.where(running & (t >= 0), t, R)
    return res, res_lp, done, evals


def unit_direction(z: torch.Tensor) -> torch.Tensor:
    """z / ‖z‖ for normals (B, D): Σz² over the coordinates in order, then
    one division by sqrt(max(Σz², 1e-30)) (the kernel's 1/sqrtf)."""
    sq = z[:, 0] * z[:, 0]
    for k in range(1, z.shape[1]):
        sq = sq + z[:, k] * z[:, k]
    inv = torch.ones_like(sq) / torch.sqrt(torch.clamp(sq, min=1e-30))
    return z * inv[:, None]


def slice_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, width: float,
    max_stepout: int, max_shrink: int, burn: int, thin: int, n_samples: int,
    iteration_offset: int = 0, stats: Optional[dict] = None,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_slice_sample`; ``cuda_density`` is unused). ``stats``, if
    given, receives ``density_evals``: the density evaluations the chains
    needed, summed over chains and steps."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    P = (d + 1) // 2
    n_words = 2 * P + 3 + max_shrink  # the normals, U, U₀, V, the trips
    ld = lambda pts: tile_fn(pts.T, *consts)[0]
    x, l = params_t.T, lp[0]
    n_steps = burn + n_samples * thin
    total = 0
    chunk = noise_chunk(n_chains, n_words)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, iteration_offset + 1 + t0, n, n_chains, n_words,
                            params_t.device)
        z = box_muller(u, d)
        for t in range(n):
            x, l, done, evals = slice_trips(
                x, l, unit_direction(z[t].T), l + torch.log(u[t, :, 2 * P]),
                u[t, :, 2 * P + 1], u[t, :, 2 * P + 2], u[t, :, 2 * P + 3:].T, ld,
                width, max_stepout)
            total += int(evals.sum())
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x.T, l[None], done.to(torch.float32)[None]
    if stats is not None:
        stats["density_evals"] = total
    return samples, lps, accs


def _check(params_t, lp, consts, width, max_stepout, max_shrink, burn, thin, n_samples):
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    if tuple(lp.shape) != (1, params_t.shape[1]):
        raise ValueError(f"lp must be (1, {params_t.shape[1]})")
    if not width > 0 or max_stepout < 1 or max_shrink < 1:
        raise ValueError("width > 0, max_stepout >= 1 and max_shrink >= 1 are required")
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp and consts must be on one device")


@traced("kernel.slice")
def fused_slice_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, width: float,
    max_stepout: int, max_shrink: int, burn: int, thin: int, n_samples: int,
    iteration_offset: int = 0,
):
    """Burn-in + thinned slice sampling (≙ pallas_slice.py::fused_slice_sample).

    Returns samples ``(n_samples, d, C)``, lps ``(n_samples, 1, C)`` and
    accepted ``(n_samples, 1, C)`` (float32: 1 unless the chain exhausted its
    shrink trips on the last step before the sample)."""
    _check(params_t, lp, consts, width, max_stepout, max_shrink, burn, thin, n_samples)
    kw = dict(width=width, max_stepout=max_stepout, max_shrink=max_shrink, burn=burn,
              thin=thin, n_samples=n_samples, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return slice_sample_reference(tile_fn, cuda_density, params_t, lp, consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    p, l = params_t.contiguous(), lp.contiguous()
    d, n_chains = p.shape
    flat, n_consts = _build.flat_consts(consts, p.device)
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    _build.launch("amh_slice_sample", "slice", cuda_density, d, p.device, p, l, flat, n_consts,
                  float(width), int(max_stepout), int(max_shrink), seed, burn, thin, n_samples,
                  iteration_offset, n_chains, samples, lps, accs)
    fused_slice_sample.launches += 1
    return samples, lps, accs


fused_slice_sample.launches = 0
