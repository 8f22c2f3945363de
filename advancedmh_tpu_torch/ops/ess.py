"""Fused elliptical slice sampling: the CUDA kernel's wrapper and its plain
version.

≙ advancedmh_tpu/ops/pallas_ess.py. The kernel (``csrc/ess.cu``) runs
burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. The model's density is the log-likelihood ℓ; the
Gaussian prior N(μ, Σ) enters through the ellipse. A step:

    ν − μ = L z (lower Cholesky L, IEEE float32) or σ ⊙ z,
    log y = ℓ(x) + log U,   θ₀ = 2π·U_θ,   bracket [θ₀ − 2π, θ₀],
    trip k: x' = (μ + (x − μ)·cos θ) + (ν − μ)·sin θ; accept iff ℓ(x') > log y,
        else the rejected θ becomes the end on its own side of 0 and
        θ = θ_min + U_k·(θ_max − θ_min),

for at most ``max_shrink`` trips; a chain that exhausts them keeps its state
and reports accepted = 0. The same deterministic move (:func:`ess_trips`) is
the torch engine's (samplers/ess.py), given its own draws.

Noise of absolute step j of a chain (csrc/common.cuh::StepWords): the d
normals' Box-Muller words 0 .. 2P−1, U (word 2P), U_θ (2P+1), then trip k's
uniform at word 2P+2+k. Layout: chains on the last axis, params ``(d, C)``,
lp ``(1, C)``; ``loc`` is ``(d,)`` and ``scale`` ``(d,)`` or ``(d, d)``. The
kernel runs a chain on 8 lanes, coordinate i on lane i mod 8, 16 chains a
128-thread block; :func:`ess_launch_info` reports the shape. The wrapper
runs the plain version for tensors on the CPU, and for CUDA tensors
launches the kernel or raises; ``fused_ess_sample.launches`` counts the
launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils.trace import traced
from . import _build
from .common import TWO_PI, box_muller, noise_chunk, perturb, philox_uniforms, scale_block


def ess_trips(x, lp, nu_c, loc, logy, theta0, trip_u, ld: Callable):
    """The deterministic part of an elliptical slice step over B chains.

    ``x`` and ``nu_c`` = ν − μ are (B, D), ``loc`` μ broadcasts against
    them, ``lp``, ``logy`` and ``theta0`` are (B,), ``trip_u`` (S, B) holds
    the uniform drawn after each rejected trip and ``ld(points (B, D)) ->
    (B,)`` is the log-likelihood. Up to S masked trips, exiting once every
    chain has accepted. Returns (x, lp, done, evals): the trips each chain
    needed (the kernel's count)."""
    done = torch.zeros(lp.shape, dtype=torch.bool, device=lp.device)
    evals = torch.zeros(lp.shape, dtype=torch.int32, device=lp.device)
    theta, tmin, tmax = theta0, theta0 - TWO_PI, theta0
    res, res_lp = x, lp
    for i in range(trip_u.shape[0]):
        if bool(done.all()):
            break
        cand = (loc + (x - loc) * torch.cos(theta)[:, None]) + nu_c * torch.sin(theta)[:, None]
        lp_c = ld(cand)
        evals += ~done
        ok = lp_c > logy  # strict, and False for NaN
        newly = ok & ~done
        res = torch.where(newly[:, None], cand, res)
        res_lp = torch.where(newly, lp_c, res_lp)
        done = done | ok
        running = ~done
        tmin = torch.where(running & (theta < 0), theta, tmin)
        tmax = torch.where(running & (theta >= 0), theta, tmax)
        theta = tmin + trip_u[i] * (tmax - tmin)
    return res, res_lp, done, evals


def ess_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, loc, scale, consts: Sequence[torch.Tensor], seed: int, *,
    max_shrink: int, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
    stats: Optional[dict] = None,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_ess_sample`; ``cuda_density`` is unused). ``stats``, if
    given, receives ``density_evals``: the likelihood evaluations (trips) the
    chains needed, summed over chains and steps; and ``max_trips_4`` and
    ``max_trips_32``: the largest trip count in each group of 4 and of 32
    consecutive chains (the chains of a warp on 8 lanes a chain and on one
    thread a chain), averaged over the groups and the steps."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    mu, scale_arr, tril = prior_args(params_t, loc, scale)
    P = (d + 1) // 2
    n_words = 2 * P + 2 + max_shrink  # the normals, U, U_θ, the trips
    ld = lambda pts: tile_fn(pts.T, *consts)[0]
    x, l = params_t.T, lp[0]
    n_steps = burn + n_samples * thin
    total, group_max = 0, {4: 0.0, 32: 0.0}
    chunk = noise_chunk(n_chains, n_words)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, iteration_offset + 1 + t0, n, n_chains, n_words,
                            params_t.device)
        z = box_muller(u, d)
        for t in range(n):
            x, l, done, evals = ess_trips(
                x, l, perturb(scale_arr, tril, z[t]).T, mu, l + torch.log(u[t, :, 2 * P]),
                TWO_PI * u[t, :, 2 * P + 1], u[t, :, 2 * P + 2:].T, ld)
            total += int(evals.sum())
            if stats is not None:
                for g in group_max:
                    group_max[g] += _group_max_mean(evals, g)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = x.T, l[None], done.to(torch.float32)[None]
    if stats is not None:
        stats["density_evals"] = total
        for g, v in group_max.items():
            stats[f"max_trips_{g}"] = v / n_steps
    return samples, lps, accs


def _group_max_mean(evals: torch.Tensor, g: int) -> float:
    """The mean over groups of ``g`` consecutive chains of each group's
    largest count (the last group may be short)."""
    pad = (-evals.numel()) % g
    e = torch.cat([evals, evals.new_zeros(pad)]) if pad else evals
    return float(e.reshape(-1, g).amax(1).double().mean())


def check_prior_step(params_t, lp, consts, burn, thin, n_samples):
    """The checks every prior-ellipse wrapper (ESS, pCN) makes."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    if tuple(lp.shape) != (1, params_t.shape[1]):
        raise ValueError(f"lp must be (1, {params_t.shape[1]})")
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp and consts must be on one device")


def prior_args(params_t, loc, scale):
    """The prior as the kernels take it: μ (d,) and the scale (d,) or the
    lower Cholesky factor (d, d), contiguous float32 on the params' device,
    and whether the scale is a factor."""
    d = params_t.shape[0]
    mu = torch.as_tensor(loc, dtype=torch.float32).to(params_t.device).reshape(-1)
    if mu.numel() not in (1, d):
        raise ValueError(f"loc must be a scalar or length {d}")
    scale_arr, tril = scale_block(scale, d, params_t.device)
    return mu.expand(d).contiguous(), scale_arr, tril


@traced("kernel.ess")
def fused_ess_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, loc, scale, consts: Sequence[torch.Tensor], seed: int, *,
    max_shrink: int, burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned elliptical slice sampling (≙
    pallas_ess.py::fused_ess_sample). ``tile_fn`` is the log-likelihood's
    tile form and ``lp`` its value at ``params_t``. Returns samples
    ``(n_samples, d, C)``, lps ``(n_samples, 1, C)`` and accepted
    ``(n_samples, 1, C)`` (float32: 1 unless the chain exhausted its trips
    on the last step before the sample)."""
    check_prior_step(params_t, lp, consts, burn, thin, n_samples)
    if max_shrink < 1:
        raise ValueError("max_shrink >= 1 is required")
    kw = dict(max_shrink=max_shrink, burn=burn, thin=thin, n_samples=n_samples,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return ess_sample_reference(tile_fn, cuda_density, params_t, lp, loc, scale, consts,
                                    seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    mu, scale_arr, tril = prior_args(params_t, loc, scale)
    p, l = params_t.contiguous(), lp.contiguous()
    d, n_chains = p.shape
    flat, n_consts = _build.flat_consts(consts, p.device)
    # raises before a launch the card would refuse
    ess_launch_info(cuda_density, d, tril, n_consts, n_chains)
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    _build.launch("amh_ess_sample", "ess", cuda_density, d, p.device, int(tril), p, l, mu,
                  scale_arr, flat, n_consts, int(max_shrink), seed, burn, thin, n_samples,
                  iteration_offset, n_chains, samples, lps, accs)
    fused_ess_sample.launches += 1
    return samples, lps, accs


fused_ess_sample.launches = 0


def ess_launch_info(cuda_density: str, d: int, tril: bool, n_consts: int,
                    n_chains: int) -> dict:
    """:func:`~._build.launch_info` of the kernel with a lower-triangular
    (``tril``) or a diagonal prior scale."""
    return _build.launch_info("amh_ess_info", "ess", cuda_density, d, n_consts, n_chains,
                              int(tril))
