"""Fused Adaptive Metropolis: the CUDA kernel's wrapper, its plain version
and the Welford advance they share with DRAM.

≙ advancedmh_tpu/ops/pallas_am.py. The kernel (``csrc/am.cu``) runs burn-in,
then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps. A step (Roberts & Rosenthal 2009's mixture):

    fixed = U_mix < β  or  n ≤ adapt_start    (n the count before the step),
    y = x + (fixed_scale/√d)·z  (fixed),  x + (opt_scale/√d)·L z  (adapted),
    accepted iff −log U_acc > −(lp_y − lp),

then the running moments (mean, L, n) advance with the realized state on
every step (:func:`welford_advance`): adaptation never freezes.

Noise of absolute step j of a chain (csrc/common.cuh::StepWords): the d
normals' Box-Muller words 0 .. 2P−1, the mixture uniform at word 2P, the
accept uniform at 2P+1. Layout: x and mean ``(d, C)``, lp and n ``(1, C)``,
L ``(d*d, C)`` row-major per chain; only its lower triangle is read, and the
final L has zeros above the diagonal. The wrapper runs the plain version for
tensors on the CPU, and for CUDA tensors launches the kernel or raises;
``fused_am_sample.launches`` counts the launches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.trace import traced
from . import _build
from .cholesky import chol_rank1_update_batched
from .common import box_muller, noise_chunk, philox_uniforms

MAX_DIM = 8  # as pallas_am.py and pallas_dram.py: the kernels unroll the d x d sweep


def _f32(v: float) -> float:
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class AmParams:
    """The sampler's constants (≙ ``AdaptiveMetropolis``'s fields)."""

    beta: float = 0.05
    fixed_scale: float = 0.1
    opt_scale: float = 2.38
    adapt_start: Optional[int] = None

    def constants(self, d: int) -> Tuple[float, float, float, float]:
        """(β, fixed_scale/√d, opt_scale/√d, adapt_start) as the kernel takes
        them, each rounded once from float64 to float32; adapt_start None is
        2d (pallas_am.py:115-116, 254-255)."""
        start = 2 * d if self.adapt_start is None else int(self.adapt_start)
        return (_f32(self.beta), _f32(self.fixed_scale / math.sqrt(d)),
                _f32(self.opt_scale / math.sqrt(d)), _f32(start))


def tri_rows(L: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """L z for L ``(d*d, C)`` row-major per chain and z ``(d, C)``: row i
    sums k = 0..i in order (csrc/common.cuh::tri_matvec)."""
    d = z.shape[0]
    rows = []
    for i in range(d):
        acc = L[i * d : i * d + 1] * z[0:1]
        for k in range(1, i + 1):
            acc = acc + L[i * d + k : i * d + k + 1] * z[k : k + 1]
        rows.append(acc)
    return torch.cat(rows)


def welford_advance(x, mean, L, n):
    """(mean, L, n) after consuming the states ``x`` ``(d, C)``, in the
    kernels' order (csrc/common.cuh::welford_chol_advance): inv = 1/(n+1),
    mean += δ·inv, L ← rank1_update(sqrt(n·inv)·L, (sqrt(n)·inv)·δ)."""
    d, C = x.shape
    n1 = n + 1.0
    inv = torch.ones_like(n1) / n1
    delta = x - mean
    mean = mean + delta * inv
    shrink = torch.sqrt(n * inv)
    coeff = torch.sqrt(n) * inv
    L_new, _ = chol_rank1_update_batched((shrink * L).T.reshape(C, d, d), (coeff * delta).T, 1.0)
    return mean, L_new.reshape(C, d * d).T, n1


def am_step(x, lp, mean, L, n, z, u_mix, logu, k, tile_fn, consts):
    """One AM step on the chain block (the kernel's arithmetic); ``k`` is
    :meth:`AmParams.constants`. Returns (x, lp, mean, L, n, accepted)."""
    beta, fs, os_, start = k
    fixed = (u_mix < beta) | (n <= start)
    y = torch.where(fixed, x + fs * z, x + os_ * tri_rows(L, z))
    lp_y = tile_fn(y, *consts)
    accept = -logu > -(lp_y - lp)
    x = torch.where(accept, y, x)
    lp = torch.where(accept, lp_y, lp)
    return (x, lp, *welford_advance(x, mean, L, n), accept)


def lower(L: torch.Tensor, d: int) -> torch.Tensor:
    """``(d*d, C)`` with the entries above the diagonal zeroed: what the
    kernels read of a factor."""
    keep = torch.tril(torch.ones(d, d, dtype=torch.bool, device=L.device)).reshape(d * d, 1)
    return torch.where(keep, L, torch.zeros_like(L))


def run_am_family(step, n_words, params_t, lp, mean, L, n, seed, burn, thin, n_samples,
                  iteration_offset):
    """The plain versions' launch body (csrc/am.cuh::am_family_run):
    ``step(x, lp, mean, L, n, u (C, n_words) uniforms)`` runs one step."""
    d, n_chains = params_t.shape
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    state = (params_t, lp, mean, lower(L, d), n)
    n_steps = burn + n_samples * thin
    chunk = noise_chunk(n_chains, n_words)
    for t0 in range(0, n_steps, chunk):
        m = min(chunk, n_steps - t0)
        u = philox_uniforms(seed, iteration_offset + 1 + t0, m, n_chains, n_words,
                            params_t.device)
        for t in range(m):
            *state, acc = step(*state, u[t])
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e] = state[0], state[1], acc.to(torch.float32)
    return (samples, lps, accs, *state[2:])


def am_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, mean: torch.Tensor, L: torch.Tensor, n: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, burn: int, thin: int, n_samples: int,
    params: AmParams = AmParams(), iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_am_sample`; ``cuda_density`` is unused)."""
    d = params_t.shape[0]
    P = (d + 1) // 2
    k = params.constants(d)

    def step(x, l, m, L_, n_, u):
        return am_step(x, l, m, L_, n_, box_muller(u[None], d)[0], u[None, :, 2 * P],
                       torch.log(u[None, :, 2 * P + 1]), k, tile_fn, consts)

    return run_am_family(step, 2 * P + 2, params_t, lp, mean, L, n, seed, burn, thin,
                         n_samples, iteration_offset)


def check_am_family(name, params_t, lp, mean, L, n, consts, burn, thin, n_samples):
    """The shapes and counts the AM and DRAM kernels take; d ≤ 8."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    d, C = params_t.shape
    if d > MAX_DIM:
        raise ValueError(f"fused {name} unrolls the d x d sweep; d <= {MAX_DIM}, got {d}")
    want = {"lp": (1, C), "mean": (d, C), "L": (d * d, C), "n": (1, C)}
    for key, t in zip(want, (lp, mean, L, n)):
        if tuple(t.shape) != want[key] or t.dtype != torch.float32:
            raise ValueError(f"{key} must be a float32 {want[key]} tensor")
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, mean, L, n, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp, mean, L, n and consts must be on one device")


def launch_am_family(entry, kernel, cuda_density, params_t, lp, mean, L, n, consts,
                     constants, seed, burn, thin, n_samples, iteration_offset):
    """Launch the AM or DRAM kernel (``entry`` its C entry point, ``constants``
    its float arguments); returns (samples, lps, accs, mean, L, n)."""
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    d, C = params_t.shape
    ins = [t.contiguous() for t in (params_t, lp, mean, L, n)]
    flat, n_consts = _build.flat_consts(consts, params_t.device)
    f32 = dict(dtype=torch.float32, device=params_t.device)
    outs = (torch.empty((n_samples, d, C), **f32), torch.empty((n_samples, 1, C), **f32),
            torch.empty((n_samples, 1, C), **f32), torch.empty((d, C), **f32),
            torch.empty((d * d, C), **f32), torch.empty((1, C), **f32))
    _build.launch(entry, kernel, cuda_density, d, params_t.device, *ins, flat, n_consts,
                  *constants, seed, burn, thin, n_samples, iteration_offset, C, *outs)
    return outs


@traced("kernel.am")
def fused_am_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, mean: torch.Tensor, L: torch.Tensor, n: torch.Tensor,
    consts: Sequence[torch.Tensor], seed: int, *, burn: int, thin: int, n_samples: int,
    params: AmParams = AmParams(), iteration_offset: int = 0,
):
    """Burn-in + thinned AM with adaptation on every step
    (≙ pallas_am.py::fused_am_sample).

    Returns samples ``(n_samples, d, C)``, lps and accepted
    ``(n_samples, 1, C)`` (float32 0/1), and the final mean ``(d, C)``, L
    ``(d*d, C)`` and n ``(1, C)``."""
    check_am_family("AM", params_t, lp, mean, L, n, consts, burn, thin, n_samples)
    kw = dict(burn=burn, thin=thin, n_samples=n_samples, params=params,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return am_sample_reference(tile_fn, cuda_density, params_t, lp, mean, L, n, consts,
                                   seed, **kw)
    out = launch_am_family("amh_am_sample", "am", cuda_density, params_t, lp, mean, L, n,
                           consts, params.constants(params_t.shape[0]), seed, burn, thin,
                           n_samples, iteration_offset)
    fused_am_sample.launches += 1
    return out


fused_am_sample.launches = 0
