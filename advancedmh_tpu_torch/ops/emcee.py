"""Fused emcee stretch move: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_emcee.py. The W walkers form W / T independent
ensembles of T = ``tile_walkers`` walkers, each split into halves of H = T/2.
A step moves the first half of every ensemble against its frozen second
half, then the second half against the updated first half: walker x draws
partner p uniformly from the other half, ``z = ((a−1)u + 1)² / a``, proposes
``y = p + z (x − p)`` and accepts iff
``log u' <= (d−1) log z + lp(y) − lp(x)``. The kernel (``csrc/emcee.cu``)
runs burn-in, then ``n_samples`` thinned draws; sample k is the state after
``burn + (k+1)*thin`` steps.

Random numbers: for walker w in half h of absolute step j, the three
uniforms (partner, z, accept) are words 0-2 of Philox4x32-10 at counter
(low word of j, w, h, high word of j) under the seed, so the plain version
draws the kernel's numbers.

Layout: walkers on the last axis, params ``(d, W)``, lp ``(1, W)``. The
wrapper runs the plain version for tensors on the CPU, and for CUDA tensors
launches the kernel or raises; ``fused_emcee_sample.launches`` counts the
launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..utils.trace import traced
from . import _build
from .common import MASK32, philox4x32_reference, uniform_from_bits


def check_walkers(n_walkers: int, tile_walkers: int) -> None:
    """Any even W split into ensembles of an even number of walkers."""
    if tile_walkers < 2 or tile_walkers % 2 or n_walkers % tile_walkers:
        raise ValueError(
            f"walkers ({n_walkers}) must split into ensembles of an even "
            f"tile_walkers ({tile_walkers}) >= 2"
        )


def emcee_uniforms(seed: int, j0: int, n: int, n_walkers: int,
                   tile_walkers: int, device):
    """The uniforms of absolute steps ``j0 .. j0+n-1``: (walker indices
    ``(2, W/2)`` of the moving walkers of each half, uniforms
    ``(n, 2, W/2, 3)``: partner, z and accept)."""
    check_walkers(n_walkers, tile_walkers)
    H = tile_walkers // 2
    i64 = dict(dtype=torch.int64, device=device)
    a = torch.arange(n_walkers // 2, **i64)
    h = torch.arange(2, **i64).view(2, 1)
    walker = (a // H) * tile_walkers + h * H + a % H  # (2, W/2)
    j = torch.arange(j0, j0 + n, **i64).view(n, 1, 1)
    shape = (n, 2, n_walkers // 2)
    counter = torch.stack(
        [(j & MASK32).expand(shape), walker.expand(shape),
         h.view(1, 2, 1).expand(shape), (j >> 32).expand(shape)],
        dim=-1,
    )
    key = (seed & MASK32, (seed >> 32) & MASK32)
    return walker, uniform_from_bits(philox4x32_reference(counter, key)[..., :3])


def stretch_draws(u, H: int, a: float):
    """The kernel's map of a moving walker's uniforms ``u`` (..., 3) to the
    partner's offset k in [0, H) within the other half, the stretch
    ``z = ((a−1)u + 1)² / a`` and the accept test's ``log u'``."""
    k = torch.clamp(torch.floor(u[..., 0] * float(H)).to(torch.int64), max=H - 1)
    a_f = torch.tensor(a, dtype=torch.float32, device=u.device)
    zz = (a_f - 1.0) * u[..., 1] + 1.0
    return k, zz * zz / a_f, torch.log(u[..., 2])


def half_move(x, lp, walker, partner, z, log_u, tile_fn, consts):
    """Move the walkers ``walker`` (n,) of one half against their partners
    ``partner`` (n,) in the other half, in place on x (d, W) and lp (1, W):
    propose ``y = p + z (x − p)`` and accept iff
    ``log_u <= (d−1) log z + lp(y) − lp(x)``. Returns the accept flags (n,)."""
    d = x.shape[0]
    xa = x[:, walker]
    xp = x[:, partner]
    y = xp + z * (xa - xp)
    lp_y = tile_fn(y, *consts)[0]
    logalpha = (d - 1) * torch.log(z) + lp_y - lp[0, walker]
    accept = log_u <= logalpha
    x[:, walker] = torch.where(accept, y, xa)
    lp[0, walker] = torch.where(accept, lp_y, lp[0, walker])
    return accept


def red_black_step(x, lp, walker, partner, z, log_u, tile_fn, consts):
    """One step, in place on x and lp: the walkers ``walker[0]`` (W/2,) move
    against their partners ``partner[0]`` in the frozen second halves, then
    ``walker[1]`` against ``partner[1]`` in the updated first halves (z and
    log_u ``(2, W/2)`` likewise). Returns the accept flags (2, W/2)."""
    return torch.stack([half_move(x, lp, walker[h], partner[h], z[h], log_u[h],
                                  tile_fn, consts) for h in range(2)])


def emcee_sample_reference(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *,
    stretch_length: float, tile_walkers: int, burn: int, thin: int,
    n_samples: int, iteration_offset: int = 0,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_emcee_sample`; ``cuda_density`` is unused)."""
    d, W = params_t.shape
    T = tile_walkers
    H = T // 2
    f32 = dict(dtype=torch.float32, device=params_t.device)
    samples = torch.empty((n_samples, d, W), **f32)
    lps = torch.empty((n_samples, 1, W), **f32)
    accs = torch.empty((n_samples, 1, W), **f32)
    x, l = params_t.clone(), lp.clone()
    acc = torch.empty((W,), dtype=torch.bool, device=params_t.device)
    n_steps = burn + n_samples * thin
    chunk = max(1, (1 << 20) // max(1, W))
    for t0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - t0)
        walker, u = emcee_uniforms(seed, iteration_offset + 1 + t0, n, W, T,
                                   params_t.device)
        other = (walker // T) * T + (1 - torch.arange(2, device=walker.device)
                                     ).view(2, 1) * H
        for t in range(n):
            k, z, log_u = stretch_draws(u[t], H, stretch_length)
            acc[walker] = red_black_step(x, l, walker, other + k, z, log_u, tile_fn, consts)
            s = t0 + t + 1
            if s > burn and (s - burn) % thin == 0:
                e = (s - burn) // thin - 1
                samples[e], lps[e], accs[e, 0] = x, l, acc.to(torch.float32)
    return samples, lps, accs


@traced("kernel.emcee")
def fused_emcee_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *,
    stretch_length: float, tile_walkers: int, burn: int, thin: int,
    n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned red-black stretch moves (≙
    pallas_emcee.py::fused_emcee_sample). Returns samples
    ``(n_samples, d, W)``, lps and accepted ``(n_samples, 1, W)`` (float32
    0/1)."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, W) tensor")
    d, W = params_t.shape
    check_walkers(W, tile_walkers)
    if tuple(lp.shape) != (1, W):
        raise ValueError(f"lp must be a (1, {W}) tensor")
    if min(burn, thin - 1, n_samples - 1) < 0:
        raise ValueError("burn >= 0, thin >= 1 and n_samples >= 1 are required")
    for t in (lp, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp and consts must be on one device")
    kw = dict(stretch_length=stretch_length, tile_walkers=tile_walkers,
              burn=burn, thin=thin, n_samples=n_samples,
              iteration_offset=iteration_offset)
    if params_t.device.type == "cpu":
        return emcee_sample_reference(tile_fn, cuda_density, params_t, lp,
                                      consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    x_state = params_t.to(torch.float32, copy=True).contiguous()
    lp_state = lp.to(torch.float32, copy=True).contiguous()
    flat, n_consts = _build.flat_consts(consts, x_state.device)
    f32 = dict(dtype=torch.float32, device=x_state.device)
    samples = torch.empty((n_samples, d, W), **f32)
    lps = torch.empty((n_samples, 1, W), **f32)
    accs = torch.empty((n_samples, 1, W), **f32)
    _build.launch("amh_emcee_sample", "emcee", cuda_density, d, x_state.device, x_state,
                  lp_state, flat, n_consts, float(stretch_length), W, tile_walkers, seed, burn,
                  thin, n_samples, iteration_offset, samples, lps, accs)
    fused_emcee_sample.launches += 1
    return samples, lps, accs


fused_emcee_sample.launches = 0
