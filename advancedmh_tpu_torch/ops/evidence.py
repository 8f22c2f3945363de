"""Fused power-posterior RWMH: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_evidence.py. The evidence estimators
(runtime/evidence.py) run K ladder rungs × C chains as one flat batch of B
chains against ``π_β(x) ∝ p(x)·L(x)^β`` with a per-chain β. The kernel
(``csrc/evidence.cu``) is dual-averaging RWMH (``csrc/adapt.cu``) with
three changes:

- the target factorizes: it carries ``(log p(x), log L(x))`` apart, β enters
  only the accept test ``log u < (lp_c + β·ll_c) − (lp + β·ll)`` (so β = 0
  beside ll = −inf is NaN and rejects), and each emitted draw writes only
  its log-likelihood and accept flag, which is what the stepping-stone and
  TI estimators read;
- β and the initial step size ε₀ are per-chain ``(1, B)`` rows, and the
  dual averaging's μ is per chain, ``log ε₀ + log 10`` in float32 (the
  Pallas kernel's form);
- the prior is an elementwise Gaussian evaluated in the kernel from its
  ``(loc, scale)`` columns: ``Σᵢ (−½zᵢ)·zᵢ − log sᵢ − ½log 2π`` with
  ``zᵢ = (xᵢ − locᵢ)/sᵢ``, rows summed in order.

Burn-in runs at ``ε = exp(log ε)`` with per-chain HG14 dual averaging toward
``target_accept`` (``adapt=True``) or at ε₀ exactly; then ``n_samples``
thinned draws at the frozen ``ε̄ = exp(log ε̄)`` (or ε₀), draw k after
``burn + (k+1)·thin`` steps, the accept flag of a thinned draw its last
step's. Step j's noise is RWMH's (ops/rwmh.py::step_noise) of its absolute
index, so the plain version equals the kernel given the same seed.

Layout: chains on the last axis, x ``(d, B)``. The kernel runs a chain of
the logistic regression on 8 lanes, 16 chains a 128-thread block, with the
likelihood's value alone (``csrc/group.cuh``), and the conjugate and flat
likelihoods one thread a chain; :func:`evidence_launch_info` reports the
shape. The wrapper runs the plain version for tensors on the CPU, and for
CUDA tensors launches the kernel or raises;
``fused_power_rwmh_sample.launches`` counts the launches.
"""
from __future__ import annotations

import math
import types
from typing import Callable, Optional, Sequence

import torch

from . import _build
from .hmc import f32
from .hmc_adapt import dual_average_step
from .rwmh import _noise_chunk, check_cuda_launch, row_sum, step_noise

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gaussian_prior_lp(x: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor,
                      log_scale: torch.Tensor) -> torch.Tensor:
    """log p(x) ``(1, C)`` of the elementwise Gaussian prior at ``x`` (d, C)
    from its columns ``loc``, ``scale`` and ``log scale`` (d, 1), the rows
    summed in order (the kernel's arithmetic: it divides by the scale)."""
    z = (x - loc) / scale
    return row_sum(-0.5 * z * z - log_scale - _HALF_LOG_2PI)


def power_step(x, ll, plp, beta, eps, z, logu, loglik_fn: Callable, prior_fn: Callable):
    """One RWMH step on π_β ∝ p·L^β: ``y = x + ε·z`` (x and z (d, C); ll,
    plp, β, ε and log u (1, C) or broadcasting), accepted iff
    ``log u < (lp_y + β·ll_y) − (lp + β·ll)``. ``loglik_fn`` and
    ``prior_fn`` map (d, C) to (1, C). Returns (x, ll, plp, accepted)."""
    cand = x + eps * z
    ll_c = loglik_fn(cand)
    plp_c = prior_fn(cand)
    accept = logu < (plp_c + beta * ll_c) - (plp + beta * ll)
    return (torch.where(accept, cand, x), torch.where(accept, ll_c, ll),
            torch.where(accept, plp_c, plp), accept)


def _check(x_t, ll, plp, beta, eps0, loc, scale, consts, counts):
    if x_t.ndim != 2 or x_t.dtype != torch.float32:
        raise ValueError("x_t must be a float32 (d, B) tensor")
    d, n_chains = x_t.shape
    if n_chains < 1:
        raise ValueError("need at least one chain")
    for name, t in (("ll", ll), ("plp", plp), ("beta", beta), ("eps0", eps0)):
        if tuple(t.shape) != (1, n_chains) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 (1, {n_chains}) tensor")
    for name, t in (("loc", loc), ("scale", scale)):
        if tuple(t.shape) != (d,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be a float32 ({d},) tensor")
    for t in (ll, plp, beta, eps0, loc, scale, *consts):
        if t.device != x_t.device:
            raise ValueError("all inputs must be on x_t's device")
    if min(counts) < 0:
        raise ValueError("step counts must be non-negative (and thin, n_samples >= 1)")


def power_rwmh_reference(
    tile_fn: Callable, cuda_density: Optional[str], x_t: torch.Tensor, ll: torch.Tensor,
    plp: torch.Tensor, beta: torch.Tensor, eps0: torch.Tensor, loc: torch.Tensor,
    scale: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, n_samples: int,
    burn: int, thin: int = 1, adapt: bool = True, target_accept: float = 0.234,
    t0: float = 10.0, kappa: float = 0.75, gamma: float = 0.05, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_power_rwmh_sample`; ``cuda_density`` is unused)."""
    d, n_chains = x_t.shape
    f = dict(dtype=torch.float32, device=x_t.device)
    lls = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    loc_c, scale_c = loc.reshape(d, 1), scale.reshape(d, 1)
    log_scale = torch.log(scale_c)

    def loglik_fn(y):
        return tile_fn(y, *consts)

    def prior_fn(y):
        return gaussian_prior_lp(y, loc_c, scale_c, log_scale)

    eps = eps0
    if adapt:
        le0 = torch.log(eps0)
        da = types.SimpleNamespace(target_accept=f32(target_accept), t0=f32(t0),
                                   kappa=f32(kappa), gamma=f32(gamma),
                                   mu=le0 + math.log(10.0))
        log_eps, leb, h_bar = le0, le0, torch.zeros_like(le0)
        if burn == 0:
            eps = torch.exp(leb)
    x, l, p = x_t, ll, plp
    n_steps = burn + n_samples * thin
    chunk = _noise_chunk(n_chains)
    for s0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - s0)
        z, logu = step_noise(seed, iteration_offset + 1 + s0, n, n_chains, d, x_t.device)
        for i in range(n):
            s = s0 + i + 1
            if s <= burn and adapt:
                x, l, p, acc = power_step(x, l, p, beta, torch.exp(log_eps), z[i], logu[i][None],
                                          loglik_fn, prior_fn)
                log_eps, leb, h_bar = dual_average_step(s, acc, log_eps, leb, h_bar, da)
                if s == burn:
                    eps = torch.exp(leb)
                continue
            x, l, p, acc = power_step(x, l, p, beta, eps, z[i], logu[i][None], loglik_fn,
                                      prior_fn)
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                lls[e], accs[e] = l, acc.to(torch.float32)
    return lls, accs, eps.clone()


def fused_power_rwmh_sample(
    tile_fn: Callable, cuda_density: Optional[str], x_t: torch.Tensor, ll: torch.Tensor,
    plp: torch.Tensor, beta: torch.Tensor, eps0: torch.Tensor, loc: torch.Tensor,
    scale: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, n_samples: int,
    burn: int, thin: int = 1, adapt: bool = True, target_accept: float = 0.234,
    t0: float = 10.0, kappa: float = 0.75, gamma: float = 0.05, iteration_offset: int = 0,
):
    """The whole K·C ladder batch in one launch (≙ pallas_evidence.py::
    fused_power_rwmh). ``x_t`` (d, B); ``ll``, ``plp``, ``beta``, ``eps0``
    (1, B); ``loc``, ``scale`` (d,) the prior's columns; ``consts`` the
    likelihood's tile constants. Returns the log-likelihood draws and
    accept flags ``(n_samples, 1, B)`` and the frozen ε̄ (or ε₀) ``(1, B)``."""
    _check(x_t, ll, plp, beta, eps0, loc, scale, consts,
           (burn, thin - 1, n_samples - 1))
    kw = dict(n_samples=n_samples, burn=burn, thin=thin, adapt=adapt,
              target_accept=target_accept, t0=t0, kappa=kappa, gamma=gamma,
              iteration_offset=iteration_offset)
    if x_t.device.type == "cpu":
        return power_rwmh_reference(tile_fn, cuda_density, x_t, ll, plp, beta, eps0, loc,
                                    scale, consts, seed, **kw)
    check_cuda_launch(x_t, seed, iteration_offset)
    lib = _build.library()
    d, n_chains = x_t.shape
    n_consts = sum(c.numel() for c in consts)
    # raises before a launch the card would refuse
    evidence_launch_info(cuda_density, d, adapt, n_consts, n_chains)
    flat = torch.cat([c.reshape(-1).to(torch.float32) for c in consts] + [loc, scale]).contiguous()
    ins = [t.contiguous() for t in (x_t, ll, plp, beta, eps0)]
    f = dict(dtype=torch.float32, device=x_t.device)
    lls = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    eps_out = torch.empty((1, n_chains), **f)
    with torch.cuda.device(x_t.device):
        code = lib.amh_power_rwmh_sample(
            _build.density_arg(cuda_density), d, int(adapt), *(t.data_ptr() for t in ins),
            flat.data_ptr(), n_consts, f32(target_accept), f32(t0), f32(kappa),
            f32(gamma), seed, burn, thin, n_samples, iteration_offset, n_chains,
            lls.data_ptr(), accs.data_ptr(), eps_out.data_ptr(),
            torch.cuda.current_stream(x_t.device).cuda_stream,
        )
    _build.check(lib, code, "evidence", cuda_density, d)
    fused_power_rwmh_sample.launches += 1
    return lls, accs, eps_out


fused_power_rwmh_sample.launches = 0


def evidence_launch_info(cuda_density: str, d: int, adapt: bool, n_consts: int,
                         n_chains: int) -> dict:
    """:func:`~._build.launch_info` of the kernel with (``adapt``) or
    without the dual averaging."""
    return _build.launch_info("amh_evidence_info", "evidence", cuda_density, d, n_consts,
                              n_chains, int(adapt))
