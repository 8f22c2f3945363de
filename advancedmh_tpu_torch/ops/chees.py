"""Fused ChEES-HMC: the CUDA kernels' wrappers and their plain versions.

≙ advancedmh_tpu/ops/pallas_chees.py. Two kernels, in ``csrc/chees.cu``:

- ``fused_chees_warmup_block`` (≙ ``_chees_warmup_kernel`` with
  ``_chees_adapt_step``): ``len(trips)·n_groups`` warmup steps. Step k
  (0-based) runs one HMC trajectory of ``trips[k mod E]`` leapfrog steps at
  ``ε = exp(log ε)`` and the tile's M⁻¹, accepts iff ``-log u > -logα``, then
  adapts from statistics pooled over the chain tile (``tile_chains`` chains;
  the last tile may be short and pools over its own chains):

  1. w = min(1, e^logα) (0 where ``|logα| < 1e30`` fails), healthy = every
     ``|y|`` and ``|p₁|`` below 1e10; pooled Σw, Σhealthy, Σx, Σy over the
     healthy chains;
  2. dual averaging of log ε on the tile's mean w (HG14);
  3. the ChEES gradient: contrib = w·Δ·⟨y − ȳ, M⁻¹p₁⟩·healthy with
     Δ = ‖y − ȳ‖² − ‖x − x̄‖² (0 where ``|contrib| < 1e30`` fails), pooled
     Σcontrib and Σw·healthy, and this step's Σx, Σx² of the new states;
  4. Adam ascent on log T with ``g = clip(u·T·Σcontrib / max(Σw·h, 1e-6),
     ±1e6)``, ``u = us[k mod E]``, log T clipped to [log ε, log(L_max·ε)];
     the running averages with η = exp(−κ·log t); with ``adapt_mass`` the
     tile's Welford moments and Stan's shrunk M⁻¹ (the identity until
     ``mass_warm_start`` observations).

  Returns the final x, lp, gradient, the last step's decisions, and per
  tile the 9 adapted scalars ``[log ε, log ε̄, H̄, log T, log T̄, m, v, t, n]``
  and the raw sums Σx, Σx² over all its steps, which
  ``runtime/fused.py::_chees_warmup_combine`` merges across tiles.
- ``fused_chees_frozen_sample`` (≙ ``_chees_frozen_kernel``): HMC at a
  frozen ε̄ (a scalar or a per-chain row) and M⁻¹ column; trajectory k
  (0-based) of the launch runs ``trips[(phase + k) mod P]`` leapfrog steps
  (``halton_trips``, P = len(trips)); sample e is the state after
  ``(e + 1)·thin`` trajectories. The kernel runs the group HMC step of
  ``csrc/hmc_group.cuh``: 8 threads a chain, 16 chains a block, on the
  logistic regression (:func:`chees_frozen_launch_info`), one thread a chain
  elsewhere.

Noise: step j (``iteration_offset + 1`` is a launch's first) draws its
momentum normals and accept uniform from Philox at counter (j, chain)
(ops/common.py::step_noise), so the plain versions see the kernels' numbers.
Pooled sums run in the kernels' order (ops/pooling.py). Each wrapper runs
its plain version for tensors on the CPU, and for CUDA tensors launches its
kernel or raises; ``<wrapper>.launches`` counts the launches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..utils.trace import traced
from . import _build
from .common import f32, noise_chunk, row_sum, step_noise
from .hmc import check_hmc_args, hmc_propose, hmc_step
from .pooling import full, n_blocks, nan_max, nan_min, per_chain, tile_sums


def vdc(i: int) -> float:
    """Van der Corput base-2 radical inverse of ``i ≥ 1`` (in (0, 1))."""
    u, f = 0.0, 0.5
    while i:
        u += f * (i & 1)
        i >>= 1
        f *= 0.5
    return u


def halton_trips(ratio: int, n: int, max_leapfrog: int) -> Tuple[int, ...]:
    """Static leapfrog-trip schedule: vdc-jittered fractions of ``ratio``
    (= round(T̄/ε̄)), clipped to [1, min(ratio, max_leapfrog)]."""
    hi = max(1, min(int(ratio), int(max_leapfrog)))
    return tuple(max(1, min(hi, round(vdc(e + 1) * ratio))) for e in range(n))


@dataclasses.dataclass(frozen=True)
class CheesParams:
    """The warmup kernel's constants: each formed in float64 from the
    sampler's settings, as the JAX kernel forms its Python-float statics,
    then rounded to float32 (``(1 − b1)`` is not ``1 − f32(b1)``)."""

    target: float
    t0: float
    kappa: float
    gamma: float
    mu: float
    lr: float
    b1: float
    one_minus_b1: float
    b2: float
    one_minus_b2: float
    log_b1: float
    log_b2: float
    log_max_leapfrog: float
    adapt_mass: bool
    mass_reg: float
    warm_start: float

    @classmethod
    def of(cls, sampler) -> "CheesParams":
        b1, b2 = float(sampler.adam_b1), float(sampler.adam_b2)
        return cls(
            target=f32(sampler.target_accept), t0=f32(sampler.t0),
            kappa=f32(sampler.kappa), gamma=f32(sampler.gamma), mu=f32(sampler._mu),
            lr=f32(sampler.learning_rate), b1=f32(b1), one_minus_b1=f32(1.0 - b1),
            b2=f32(b2), one_minus_b2=f32(1.0 - b2),
            log_b1=f32(math.log(b1) if b1 > 0.0 else -1e30),
            log_b2=f32(math.log(b2) if b2 > 0.0 else -1e30),
            log_max_leapfrog=f32(math.log(float(sampler.max_leapfrog))),
            adapt_mass=bool(sampler.adapt_mass),
            mass_reg=f32(sampler.mass_regularization),
            warm_start=float(sampler.mass_warm_start),
        )

    def args(self):
        """The C entry point's float arguments, in its order."""
        return (self.target, self.t0, self.kappa, self.gamma, self.mu, self.lr,
                self.b1, self.one_minus_b1, self.b2, self.one_minus_b2, self.log_b1,
                self.log_b2, self.log_max_leapfrog, self.mass_reg, self.warm_start)


def n_tiles_of(n_chains: int, tile_chains: int) -> int:
    return -(-n_chains // tile_chains)


def _tile_sizes(n_chains: int, tile: int, like: torch.Tensor) -> torch.Tensor:
    n = n_tiles_of(n_chains, tile)
    sizes = [float(min(tile, n_chains - i * tile)) for i in range(n)]
    return torch.tensor(sizes, dtype=torch.float32, device=like.device)


def _clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), NaN if any side is NaN."""
    return nan_min(nan_max(x, lo), hi)


def chees_warmup_reference(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, trips: Sequence[int],
    us: Sequence[float], n_groups: int, sv: torch.Tensor,
    inverse_mass: torch.Tensor, params: CheesParams, tile_chains: int,
    iteration_offset: int = 0,
):
    """Plain PyTorch version of the warmup kernel (same signature and
    outputs as :func:`fused_chees_warmup_block`; ``cuda_density`` is
    unused)."""
    d, C = params_t.shape
    dev = params_t.device
    tile = tile_chains
    cn = _tile_sizes(C, tile, params_t)  # chains per tile, (n_tiles,)
    sv = sv.to(torch.float32).reshape(9, 1).expand(9, cn.shape[0]).clone()
    le, leb, hb, lT, lTb, am, av, t, n = sv.unbind(0)
    minv = inverse_mass.to(torch.float32).reshape(d, 1).expand(d, cn.shape[0]).clone()
    mean = torch.zeros_like(minv)
    m2 = torch.zeros_like(minv)
    sum1 = torch.zeros_like(minv)
    sum2 = torch.zeros_like(minv)
    p = params
    x, l, g = params_t, lp, grad
    acc = torch.zeros((1, C), dtype=torch.bool, device=dev)
    E = len(trips)
    n_steps = E * n_groups
    chunk = noise_chunk(C)
    for s0 in range(0, n_steps, chunk):
        nn_ = min(chunk, n_steps - s0)
        z, logu = step_noise(seed, iteration_offset + 1 + s0, nn_, C, d, dev)
        for i in range(nn_):
            k = (s0 + i) % E
            minv_c = per_chain(minv, tile, C)
            eps_c = per_chain(torch.exp(le), tile, C)[None]
            y, p1, lp_y, g_y, logalpha = hmc_propose(x, l, g, z[i], eps_c, minv_c, trips[k],
                                                     value_and_grad, consts)
            accept = -logu[i][None] > -logalpha
            w = torch.where(torch.abs(logalpha) < 1e30,
                            torch.exp(nan_min(logalpha, 0.0)), torch.zeros_like(logalpha))
            healthy = ((torch.abs(y) < 1e10).all(0, keepdim=True)
                       & (torch.abs(p1) < 1e10).all(0, keepdim=True))
            hf = healthy.to(torch.float32)
            zero = torch.zeros_like(x)
            s1 = tile_sums(torch.cat([w, hf, torch.where(healthy, x, zero),
                                      torch.where(healthy, y, zero)]), tile)
            w_mean = s1[0] / cn
            cnt = torch.clamp(s1[1], min=1.0)
            mean0c, mean1c = s1[2:2 + d] / cnt, s1[2 + d:] / cnt
            # ε: dual averaging on the tile's mean acceptance probability
            wgt = 1.0 / (t + p.t0)
            hb = (1.0 - wgt) * hb + wgt * (p.target - w_mean)
            le = p.mu - torch.sqrt(t) / full(t, p.gamma) * hb
            eta = torch.exp(-p.kappa * torch.log(t))
            leb = eta * le + (1.0 - eta) * leb
            # T: the ChEES gradient pieces and this step's position sums
            x0c = x - per_chain(mean0c, tile, C)
            x1c = y - per_chain(mean1c, tile, C)
            delta = row_sum(x1c * x1c) - row_sum(x0c * x0c)
            dot = row_sum(x1c * (p1 * minv_c))
            contrib = w * delta * dot * hf
            contrib = torch.where(torch.abs(contrib) < 1e30, contrib, torch.zeros_like(contrib))
            x_new = torch.where(accept, y, x)
            s2 = tile_sums(torch.cat([contrib, w * hf, x_new, x_new * x_new]), tile)
            num, den = s2[0], torch.clamp(s2[1], min=1e-6)
            step_sx, step_sx2 = s2[2:2 + d], s2[2 + d:]
            sum1, sum2 = sum1 + step_sx, sum2 + step_sx2
            traj_len = us[k] * torch.exp(lT)
            g_T = torch.clamp(traj_len * num / den, -1e6, 1e6)
            am = p.b1 * am + p.one_minus_b1 * g_T
            av = p.b2 * av + p.one_minus_b2 * g_T * g_T
            m_hat = am / (1.0 - torch.exp(t * p.log_b1))
            v_hat = av / (1.0 - torch.exp(t * p.log_b2))
            log_eps_now = torch.log(torch.exp(le))
            lT = lT + p.lr * m_hat / (torch.sqrt(v_hat) + f32(1e-8))
            lT = _clip(lT, log_eps_now, p.log_max_leapfrog + log_eps_now)
            lTb = eta * lT + (1.0 - eta) * lTb
            if p.adapt_mass:
                b_mean = step_sx / cn
                m2_b = step_sx2 - step_sx * step_sx / cn
                n_new = n + cn
                dlt = b_mean - mean
                mean = mean + (cn / n_new) * dlt
                m2 = m2 + m2_b + (n * cn / n_new) * dlt * dlt
                n = n_new
                var = m2 / torch.clamp(n - 1.0, min=1.0)
                est = ((n / (n + p.mass_reg)) * var
                       + f32(1e-3) * (full(n, p.mass_reg) / (n + p.mass_reg)))
                minv = torch.where(n >= p.warm_start, est, minv)
            t = t + 1.0
            x = x_new
            l = torch.where(accept, lp_y, l)
            g = torch.where(accept, g_y, g)
            acc = accept
    sv_tiles = torch.stack([le, leb, hb, lT, lTb, am, av, t, n])
    return x, l, g, acc.to(torch.float32), sv_tiles, sum1, sum2


@traced("kernel.chees_warmup")
def fused_chees_warmup_block(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, trips: Sequence[int],
    us: Sequence[float], n_groups: int, sv: torch.Tensor,
    inverse_mass: torch.Tensor, params: CheesParams, tile_chains: int,
    iteration_offset: int = 0,
):
    """The ChEES warmup in one launch (≙ pallas_chees.py::
    fused_chees_warmup_block): ``len(trips)·n_groups`` steps, the ChEES
    statistics pooled over tiles of ``tile_chains`` chains.

    ``sv`` (9,) packs the start ``[log ε, log ε̄, H̄, log T, log T̄, m, v, t,
    n]`` and ``inverse_mass`` (d, 1) seeds each tile's M⁻¹. Returns x
    ``(d, C)``, lp ``(1, C)``, the gradient ``(d, C)``, the last step's
    decisions ``(1, C)`` (float32 0/1), the tiles' adapted scalars
    ``(9, n_tiles)`` and raw sums Σx, Σx² ``(d, n_tiles)``."""
    check_hmc_args(params_t, lp, grad, consts, (n_groups - 1,), min(trips, default=0))
    d, C = params_t.shape
    if tile_chains < 1:
        raise ValueError(f"tile_chains must be >= 1, got {tile_chains}")
    if len(trips) != len(us) or not trips:
        raise ValueError("trips and us must be non-empty and the same length")
    if tuple(inverse_mass.reshape(-1).shape) != (d,) or sv.numel() != 9:
        raise ValueError(f"inverse_mass must hold {d} values and sv 9")
    kw = dict(trips=trips, us=us, n_groups=n_groups, sv=sv, inverse_mass=inverse_mass,
              params=params, tile_chains=tile_chains, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return chees_warmup_reference(value_and_grad, cuda_density, params_t, lp, grad,
                                      consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    dev = params_t.device
    p, l, g = params_t.contiguous(), lp.contiguous(), grad.contiguous()
    flat, n_consts = _build.flat_consts(consts, dev)
    f = dict(dtype=torch.float32, device=dev)
    nt = n_tiles_of(C, tile_chains)
    trips_t = torch.tensor([int(v) for v in trips], dtype=torch.int32, device=dev)
    us_t = torch.tensor([f32(v) for v in us], **f)
    sv_in = sv.to(**f).reshape(9).contiguous()
    minv_in = inverse_mass.to(**f).reshape(d).contiguous()
    out_x, out_g = torch.empty((d, C), **f), torch.empty((d, C), **f)
    out_l, out_acc = torch.empty((1, C), **f), torch.empty((1, C), **f)
    sv_tiles = torch.empty((9, nt), **f)
    sums = torch.empty((2, d, nt), **f)
    # the block partials of the two pooled rounds (2 + 2d sums each)
    partials = torch.empty((2, 2 + 2 * d, n_blocks(C, tile_chains)), **f)
    _build.launch("amh_chees_warmup", "chees", cuda_density, d, dev, p, l, g, sv_in, minv_in,
                  trips_t, us_t, len(trips), n_groups, flat, n_consts, *params.args(),
                  int(params.adapt_mass), seed, iteration_offset, C, tile_chains, out_x, out_l,
                  out_g, out_acc, sv_tiles, sums[0], sums[1], partials, partials.shape[2])
    fused_chees_warmup_block.launches += 1
    return out_x, out_l, out_g, out_acc, sv_tiles, sums[0], sums[1]


def chees_frozen_reference(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, trips: Sequence[int], phase: int,
    step_size: torch.Tensor, inverse_mass: torch.Tensor, thin: int, n_samples: int,
    iteration_offset: int = 0,
):
    """Plain PyTorch version of the frozen kernel (same signature and
    outputs as :func:`fused_chees_frozen_sample`)."""
    d, C = params_t.shape
    f = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, C), **f)
    lps = torch.empty((n_samples, 1, C), **f)
    accs = torch.empty((n_samples, 1, C), **f)
    eps = step_size.to(torch.float32).reshape(1, -1)
    minv = inverse_mass.to(torch.float32).reshape(d, 1)
    P = len(trips)
    x, l, g = params_t, lp, grad
    n_steps = n_samples * thin
    chunk = noise_chunk(C)
    for s0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - s0)
        z, logu = step_noise(seed, iteration_offset + 1 + s0, n, C, d, params_t.device)
        for i in range(n):
            k = s0 + i
            x, l, g, acc = hmc_step(x, l, g, z[i], logu[i], eps, minv,
                                    trips[(phase + k) % P], value_and_grad, consts)
            if (k + 1) % thin == 0:
                e = (k + 1) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, g


@traced("kernel.chees_frozen")
def fused_chees_frozen_sample(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, trips: Sequence[int], phase: int,
    step_size: torch.Tensor, inverse_mass: torch.Tensor, thin: int, n_samples: int,
    iteration_offset: int = 0,
):
    """Frozen-phase ChEES draws (≙ pallas_chees.py::fused_chees_frozen_sample).

    ``step_size`` is the frozen ε̄, one value ``(1,)``/``(1, 1)`` or one per
    chain ``(1, C)``; ``inverse_mass`` the (d, 1) column. Returns samples
    ``(n_samples, d, C)``, lps and accepted ``(n_samples, 1, C)`` (float32
    0/1) and the gradient ``(d, C)`` at the last state."""
    check_hmc_args(params_t, lp, grad, consts, (thin - 1, n_samples - 1),
                   min(trips, default=0))
    d, C = params_t.shape
    if tuple(inverse_mass.shape) != (d, 1) or inverse_mass.device != params_t.device:
        raise ValueError(f"inverse_mass must be a ({d}, 1) column on the params' device")
    if step_size.numel() not in (1, C) or step_size.device != params_t.device:
        raise ValueError(f"step_size must hold 1 or {C} values on the params' device")
    if phase < 0:
        raise ValueError("phase must be non-negative")
    kw = dict(trips=trips, phase=phase, step_size=step_size, inverse_mass=inverse_mass,
              thin=thin, n_samples=n_samples, iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return chees_frozen_reference(value_and_grad, cuda_density, params_t, lp, grad,
                                      consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    dev = params_t.device
    p, l, g = params_t.contiguous(), lp.contiguous(), grad.contiguous()
    flat, n_consts = _build.flat_consts(consts, dev)
    f = dict(dtype=torch.float32, device=dev)
    eps = step_size.to(**f).reshape(-1).contiguous()
    minv = inverse_mass.to(**f).contiguous()
    trips_t = torch.tensor([int(v) for v in trips], dtype=torch.int32, device=dev)
    samples = torch.empty((n_samples, d, C), **f)
    lps = torch.empty((n_samples, 1, C), **f)
    accs = torch.empty((n_samples, 1, C), **f)
    g_state = torch.empty((d, C), **f)
    _build.launch("amh_chees_frozen_sample", "chees", cuda_density, d, dev, p, l, g, eps,
                  int(eps.numel() > 1), minv, flat, n_consts, trips_t, len(trips), phase, seed,
                  thin, n_samples, iteration_offset, C, samples, lps, accs, g_state)
    fused_chees_frozen_sample.launches += 1
    return samples, lps, accs, g_state


def chees_frozen_launch_info(cuda_density: str, d: int, n_consts: int, n_chains: int) -> dict:
    """:func:`~._build.launch_info` of the frozen-phase kernel."""
    return _build.launch_info("amh_chees_frozen_info", "chees", cuda_density, d, n_consts,
                              n_chains)


fused_chees_warmup_block.launches = 0
fused_chees_frozen_sample.launches = 0
