"""Fused AdaptiveHMC: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_hmc_adapt.py. The kernel (``csrc/hmc_adapt.cu``)
runs ``warmup`` HMC steps that adapt, per chain, the step size by HG14 dual
averaging on the accept indicator and the diagonal inverse mass from the
Welford moments of the positions, then ``n_samples`` thinned draws with both
frozen; sample k is the state after ``warmup + (k+1)*thin`` steps. Warmup
step t (1-based) runs at ``ε = exp(log ε)`` and ``M⁻¹ = reg(M2, t − 1)``
(Stan's shrunk estimate; the identity until ``mass_warm_start``
observations), then updates (log ε, log ε̄, H̄) and folds the new position
into (mean, M2). The frozen phase runs at ``ε̄ = exp(log ε̄)`` and
``reg(M2, warmup)``. The HMC step is ops/hmc.py::hmc_step, its noise RWMH's.

The resume variant (``log_eps_bar`` and ``inverse_mass`` given) runs no
warmup: the frozen phase from the given per-chain ``log ε̄`` (1, C) and
``M⁻¹`` (d, C). Both variants form ε̄ as ``exp`` of the same stored log ε̄,
so a run split after its warmup and resumed is bit-exact.

``t^-κ`` is ``exp(-κ·log t)``, as in the JAX kernel. Layout: chains on the
last axis. The wrapper runs the plain version for tensors on the CPU, and
for CUDA tensors launches the kernel or raises;
``fused_adaptive_hmc_sample.launches`` counts the launches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from . import _build
from .hmc import check_hmc_args, f32, hmc_step
from .rwmh import _noise_chunk, check_cuda_launch, flat_consts, step_noise


@dataclasses.dataclass(frozen=True)
class DualAveraging:
    """HG14 dual-averaging constants, rounded to float32 (``mu`` None →
    log(10·ε₀))."""

    initial_step_size: float = 0.1
    target_accept: float = 0.65
    t0: float = 10.0
    kappa: float = 0.75
    gamma: float = 0.05
    mu: Optional[float] = None

    def __post_init__(self):
        mu = math.log(10.0 * self.initial_step_size) if self.mu is None else self.mu
        object.__setattr__(self, "mu", f32(mu))
        for name in ("target_accept", "t0", "kappa", "gamma"):
            object.__setattr__(self, name, f32(getattr(self, name)))

    @property
    def log_eps0(self) -> float:
        return f32(math.log(self.initial_step_size))

    def args(self):
        """The kernels' (target, t0, kappa, gamma, mu, log ε₀) arguments."""
        return (self.target_accept, self.t0, self.kappa, self.gamma, self.mu,
                self.log_eps0)


def _full(like: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a tensor shaped like ``like``. PyTorch divides a tensor by a
    Python number as a product with its reciprocal (two roundings), and a
    number by a tensor as the reciprocal times the number: the plain
    versions divide tensor by tensor, one rounding, as the kernels do."""
    return torch.full_like(like, v)


def dual_average_step(t: int, accepted, log_eps, log_eps_bar, h_bar, da: DualAveraging):
    """One HG14 update at warmup step ``t`` (the kernels' arithmetic; the
    accept indicator is a (1, C) bool)."""
    a = accepted.to(torch.float32)
    tf = _full(h_bar, float(t))
    w = 1.0 / (tf + da.t0)
    h_bar = (1.0 - w) * h_bar + w * (da.target_accept - a)
    log_eps = da.mu - torch.sqrt(tf) / _full(tf, da.gamma) * h_bar
    eta = torch.exp(-da.kappa * torch.log(tf))
    log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
    return log_eps, log_eps_bar, h_bar


def regularized_inverse_mass(m2: torch.Tensor, n: float, reg: float,
                             warm_start: float) -> torch.Tensor:
    """Stan's shrunk variance estimate from (M2, count n); the identity
    until ``warm_start`` observations."""
    nn = torch.full_like(m2, max(float(n), 1.0))
    var = m2 / torch.clamp(nn - 1.0, min=1.0)
    est = (nn / (nn + reg)) * var + f32(1e-3) * (_full(nn, reg) / (nn + reg))
    return est if float(n) >= warm_start else torch.ones_like(m2)


def adaptive_hmc_reference(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, n_leapfrog: int,
    warmup: int, thin: int, n_samples: int, da: DualAveraging = DualAveraging(),
    mass_regularization: float = 5.0, mass_warm_start: int = 10,
    log_eps_bar: Optional[torch.Tensor] = None,
    inverse_mass: Optional[torch.Tensor] = None, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_adaptive_hmc_sample`; ``cuda_density`` is unused)."""
    d, n_chains = params_t.shape
    f = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f)
    lps = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    reg, ws = f32(mass_regularization), float(mass_warm_start)
    resume = log_eps_bar is not None
    if resume:
        leb, minv = log_eps_bar, inverse_mass
        warmup = 0
    else:
        log_eps = torch.full((1, n_chains), da.log_eps0, **f)
        leb = log_eps.clone()
        h_bar = torch.zeros((1, n_chains), **f)
        mean, m2 = params_t, torch.zeros((d, n_chains), **f)
    x, l, g = params_t, lp, grad
    n_steps = warmup + n_samples * thin
    chunk = _noise_chunk(n_chains)
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        z, logu = step_noise(seed, iteration_offset + 1 + t0, n, n_chains, d, params_t.device)
        for i in range(n):
            s = t0 + i + 1
            if s <= warmup:
                minv_s = regularized_inverse_mass(m2, s - 1, reg, ws)
                x, l, g, acc = hmc_step(x, l, g, z[i], logu[i], torch.exp(log_eps), minv_s,
                                        n_leapfrog, value_and_grad, consts)
                log_eps, leb, h_bar = dual_average_step(s, acc, log_eps, leb, h_bar, da)
                delta = x - mean
                mean = mean + delta / _full(delta, float(s))
                m2 = m2 + delta * (x - mean)
                continue
            if s == warmup + 1 and not resume:
                minv = regularized_inverse_mass(m2, warmup, reg, ws)
            x, l, g, acc = hmc_step(x, l, g, z[i], logu[i], torch.exp(leb), minv,
                                    n_leapfrog, value_and_grad, consts)
            if (s - warmup) % thin == 0:
                e = (s - warmup) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, leb, minv, g


def fused_adaptive_hmc_sample(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, n_leapfrog: int,
    warmup: int, thin: int, n_samples: int, da: DualAveraging = DualAveraging(),
    mass_regularization: float = 5.0, mass_warm_start: int = 10,
    log_eps_bar: Optional[torch.Tensor] = None,
    inverse_mass: Optional[torch.Tensor] = None, iteration_offset: int = 0,
):
    """Adaptive warmup + frozen thinned HMC in one launch
    (≙ pallas_hmc_adapt.py::fused_adaptive_hmc_sample).

    Fresh: ``warmup`` adaptive steps from ε₀ and the identity mass. Resume:
    give ``log_eps_bar`` (1, C) and ``inverse_mass`` (d, C) and
    ``warmup=0``. Returns samples ``(n_samples, d, C)``, lps and accepted
    ``(n_samples, 1, C)``, the frozen log ε̄ ``(1, C)`` and M⁻¹ ``(d, C)``,
    and the gradient ``(d, C)`` at the last state."""
    check_hmc_args(params_t, lp, grad, consts, (warmup, thin - 1, n_samples - 1), n_leapfrog)
    d, n_chains = params_t.shape
    resume = log_eps_bar is not None
    if resume != (inverse_mass is not None):
        raise ValueError("the resume variant needs both log_eps_bar and inverse_mass")
    if resume:
        if warmup != 0:
            raise ValueError("the resume variant runs no warmup (warmup=0)")
        if (tuple(log_eps_bar.shape) != (1, n_chains)
                or tuple(inverse_mass.shape) != (d, n_chains)):
            raise ValueError(f"log_eps_bar must be (1, {n_chains}) and inverse_mass "
                             f"({d}, {n_chains})")
        for t in (log_eps_bar, inverse_mass):
            if t.device != params_t.device:
                raise ValueError("log_eps_bar and inverse_mass must be on the params' device")
    kw = dict(n_leapfrog=n_leapfrog, warmup=warmup, thin=thin, n_samples=n_samples, da=da,
              mass_regularization=mass_regularization, mass_warm_start=mass_warm_start,
              log_eps_bar=log_eps_bar, inverse_mass=inverse_mass,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return adaptive_hmc_reference(value_and_grad, cuda_density, params_t, lp, grad,
                                      consts, seed, **kw)
    check_cuda_launch(params_t, seed, iteration_offset)
    lib = _build.library()
    p, l, g = params_t.contiguous(), lp.contiguous(), grad.contiguous()
    flat, n_consts = flat_consts(consts, p.device)
    f = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f)
    lps = torch.empty((n_samples, 1, n_chains), **f)
    accs = torch.empty((n_samples, 1, n_chains), **f)
    leb_out = torch.empty((1, n_chains), **f)
    minv_out = torch.empty((d, n_chains), **f)
    x_state = torch.empty((d, n_chains), **f)
    g_state = torch.empty((d, n_chains), **f)
    # the Welford moments of the warmup live in device memory, not registers
    moments = torch.empty((2, d, n_chains) if warmup > 0 else (2, 1, 1), **f)
    leb_in = log_eps_bar.contiguous() if resume else leb_out
    minv_in = inverse_mass.to(torch.float32).contiguous() if resume else minv_out
    with torch.cuda.device(p.device):
        code = lib.amh_adaptive_hmc_sample(
            _build.density_arg(cuda_density), d, int(resume), p.data_ptr(), l.data_ptr(),
            g.data_ptr(), leb_in.data_ptr(), minv_in.data_ptr(), flat.data_ptr(), n_consts,
            *da.args(), f32(mass_regularization), float(mass_warm_start), n_leapfrog,
            seed, warmup, thin, n_samples, iteration_offset, n_chains,
            samples.data_ptr(), lps.data_ptr(), accs.data_ptr(), leb_out.data_ptr(),
            minv_out.data_ptr(), x_state.data_ptr(), g_state.data_ptr(),
            moments[0].data_ptr(), moments[1].data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    _build.check(lib, code, "hmc_adapt", cuda_density, d)
    fused_adaptive_hmc_sample.launches += 1
    return samples, lps, accs, leb_out, minv_out, g_state


fused_adaptive_hmc_sample.launches = 0
