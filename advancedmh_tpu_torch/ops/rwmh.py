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

Random numbers come from Philox4x32-10 with key = the seed's two 32-bit
words and counter = (low word of j, chain, sub-block, high word of j), j the
absolute step index (``iteration_offset + 1`` is the first step of a call).
The noise of a step therefore depends only on (seed, j, chain):
``rwmh_sample_reference`` and ``rwmh_reference`` draw the same normals and
uniforms as the kernels, up to the last ulp of log / sin / cos.

Each public wrapper runs its plain version for tensors on the CPU, and for
CUDA tensors launches its kernel or raises. ``<wrapper>.launches`` counts
the kernel launches.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from . import _build

_TWO_PI = 6.283185307179586
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# ---- Philox4x32-10 in plain PyTorch (same bits as csrc/philox.cuh) ---------


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) words of the 64-bit product of the constant ``a`` and the
    32-bit words ``b`` (int64). The product can exceed 2⁶³, so both factors
    are split into 16-bit halves and the partial products recombined."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = b_lo * a_lo
    lh = b_hi * a_lo
    hl = b_lo * a_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = b_hi * a_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_reference(counter: torch.Tensor, key) -> torch.Tensor:
    """Philox4x32-10 of int64 ``counter`` words ``(..., 4)`` under the two
    32-bit ``key`` words; returns the four output words ``(..., 4)`` as int64
    in [0, 2³²)."""
    c0, c1, c2, c3 = (w & _MASK32 for w in counter.unbind(-1))
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words → float32 uniforms strictly inside (0, 1)
    (≙ pallas_mh.py::_uniform_from_bits; exact in float32)."""
    return (bits & 0x7FFFFF).to(torch.float32) * 2.0**-23 + 2.0**-24


def philox_uniforms(
    seed: int, j0: int, n: int, n_chains: int, n_words: int, device
) -> torch.Tensor:
    """Words ``0 .. n_words-1`` of absolute steps ``j0 .. j0+n-1`` for every
    chain as uniforms ``(n, C, n_words)``: word w is element w % 4 of
    sub-block w / 4 of counter (j, chain) (csrc/common.cuh::StepWords)."""
    n_sub = (n_words + 3) // 4
    i64 = dict(dtype=torch.int64, device=device)
    j = torch.arange(j0, j0 + n, **i64).view(n, 1, 1)
    c = torch.arange(n_chains, **i64).view(1, n_chains, 1)
    s = torch.arange(n_sub, **i64).view(1, 1, n_sub)
    shape = (n, n_chains, n_sub)
    counter = torch.stack(
        [(j & _MASK32).expand(shape), c.expand(shape), s.expand(shape),
         (j >> 32).expand(shape)],
        dim=-1,
    )
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    words = philox4x32_reference(counter, key).reshape(n, n_chains, 4 * n_sub)
    return uniform_from_bits(words[..., :n_words])


def box_muller(u: torch.Tensor, d: int) -> torch.Tensor:
    """The d normals of uniforms ``(n, C, W)``: pair p from words 2p and
    2p+1, as ``(n, d, C)`` (csrc/common.cuh::step_normals)."""
    n, n_chains = u.shape[:2]
    pairs = (d + 1) // 2
    u1, u2 = u[..., 0 : 2 * pairs : 2], u[..., 1 : 2 * pairs : 2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z.reshape(n, n_chains, 2 * pairs)[..., :d].permute(0, 2, 1)


def step_noise(
    seed: int, j0: int, n: int, n_chains: int, d: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Noise of absolute steps ``j0 .. j0+n-1`` for every chain, as the
    kernels draw it: normals ``(n, d, C)`` (Box-Muller pairs from words 2p,
    2p+1) and ``log(u)`` ``(n, C)`` of the accept uniform (word 2P)."""
    pairs = (d + 1) // 2
    u = philox_uniforms(seed, j0, n, n_chains, 2 * pairs + 1, device)
    return box_muller(u, d), torch.log(u[..., 2 * pairs])


# ---- the plain step --------------------------------------------------------


def scale_block(scale, d: int, device) -> Tuple[torch.Tensor, bool]:
    """A user scale as the kernels take it: ``(d,)`` per-dimension std-devs,
    or a ``(d, d)`` lower Cholesky factor (tril=True)."""
    arr = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if arr.ndim == 2:
        if tuple(arr.shape) != (d, d):
            raise ValueError(f"matrix scale must be ({d}, {d}), got {tuple(arr.shape)}")
        return torch.tril(arr).contiguous(), True
    if arr.numel() not in (1, d):
        raise ValueError(f"scale must be a scalar or length {d}, got {tuple(arr.shape)}")
    return arr.reshape(-1).expand(d).contiguous(), False


def _perturb(scale: torch.Tensor, tril: bool, z: torch.Tensor) -> torch.Tensor:
    """scale * z, or L z by column accumulation (the kernel's order)."""
    if not tril:
        return scale[:, None] * z
    acc = scale[:, 0:1] * z[0:1]
    for k in range(1, scale.shape[0]):
        acc = acc + scale[:, k : k + 1] * z[k : k + 1]
    return acc


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the rows of (d, C) in row order, as the kernels add them."""
    acc = t[0:1]
    for i in range(1, t.shape[0]):
        acc = acc + t[i : i + 1]
    return acc


def softplus(t: torch.Tensor) -> torch.Tensor:
    """``max(t, 0) + log(1 + exp(−|t|))`` with raw exp and log, NaN in NaN
    out: the JAX kernels' softplus (csrc/common.cuh::softplus)."""
    return torch.maximum(t, torch.zeros_like(t)) + torch.log(1.0 + torch.exp(-torch.abs(t)))


def rwmh_step(x, lp, z, logu, scale, tril, tile_fn, consts):
    """One RWMH step on the chain block: accept iff log(u) < lp_cand − lp."""
    cand = x + _perturb(scale, tril, z)
    lp_cand = tile_fn(cand, *consts)
    accept = logu[None] < lp_cand - lp
    return torch.where(accept, cand, x), torch.where(accept, lp_cand, lp), accept


def _noise_chunk(n_chains: int, n_words: int = 4) -> int:
    """Steps of noise made per vectorized call: about 2²² Philox blocks of
    ``n_words`` words each chain-step."""
    return max(1, (1 << 22) // max(1, n_chains * ((n_words + 3) // 4)))


def _run_plain(tile_fn, params_t, lp, scale, consts, seed, n_steps, offset, on_step):
    d, n_chains = params_t.shape
    scale_arr, tril = scale_block(scale, d, params_t.device)
    x, l = params_t, lp
    chunk = _noise_chunk(n_chains)
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


def _check(params_t, lp, consts, d_counts: Sequence[int]):
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    d, n_chains = params_t.shape
    if n_chains < 1:
        raise ValueError("need at least one chain")
    if tuple(lp.shape) != (1, n_chains) or lp.dtype != torch.float32:
        raise ValueError(f"lp must be a float32 (1, {n_chains}) tensor")
    for t in (lp, *consts):
        if t.device != params_t.device:
            raise ValueError("params_t, lp and consts must be on one device")
    if min(d_counts) < 0:
        raise ValueError("step counts must be non-negative")


def flat_consts(consts: Sequence[torch.Tensor], device) -> Tuple[torch.Tensor, int]:
    """The density constants as the kernels read them: one contiguous
    float32 vector (one placeholder float when there are none) and its
    length. They go to shared memory, so at most 227 KB
    (:func:`_build.check_shared_memory`)."""
    n = sum(c.numel() for c in consts)
    _build.check_shared_memory(n)
    if not consts:
        return torch.zeros(1, dtype=torch.float32, device=device), 0
    return torch.cat([c.reshape(-1).to(torch.float32) for c in consts]).contiguous(), n


def check_cuda_launch(params_t: torch.Tensor, seed: int, iteration_offset: int) -> None:
    """What every kernel launch needs: a CUDA tensor and 64-bit counters."""
    if params_t.device.type != "cuda":
        raise ValueError(f"no kernel for device {params_t.device}")
    if not 0 <= seed < 1 << 64 or not 0 <= iteration_offset < 1 << 63:
        raise ValueError("seed and iteration_offset must fit 64 bits")


def _cuda_args(params_t, lp, scale, consts, seed, iteration_offset):
    """Validate a CUDA launch and return (lib, tril, tensors)."""
    check_cuda_launch(params_t, seed, iteration_offset)
    scale_arr, tril = scale_block(scale, params_t.shape[0], params_t.device)
    flat, n_consts = flat_consts(consts, params_t.device)
    return (_build.library(), tril, params_t.contiguous(), lp.contiguous(),
            scale_arr, flat, n_consts)


def fused_rwmh_sample(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    burn: int, thin: int, n_samples: int, iteration_offset: int = 0,
):
    """Burn-in + thinned emission (≙ pallas_mh.py::fused_rwmh_sample).

    Returns samples ``(n_samples, d, C)``, lps ``(n_samples, 1, C)`` and
    accepted ``(n_samples, 1, C)`` (float32 0/1, the decision of the last
    step before each sample)."""
    _check(params_t, lp, consts, (burn, thin - 1, n_samples - 1))
    if params_t.device.type == "cpu":
        return rwmh_sample_reference(
            tile_fn, cuda_density, params_t, lp, scale, consts, seed, burn=burn,
            thin=thin, n_samples=n_samples, iteration_offset=iteration_offset,
        )
    lib, tril, p, l, s, flat, n_consts = _cuda_args(
        params_t, lp, scale, consts, seed, iteration_offset)
    d, n_chains = p.shape
    f32 = dict(dtype=torch.float32, device=p.device)
    samples = torch.empty((n_samples, d, n_chains), **f32)
    lps = torch.empty((n_samples, 1, n_chains), **f32)
    accs = torch.empty((n_samples, 1, n_chains), **f32)
    with torch.cuda.device(p.device):
        code = lib.amh_rwmh_sample(
            _build.density_arg(cuda_density), d, int(tril), p.data_ptr(), l.data_ptr(), s.data_ptr(),
            flat.data_ptr(), n_consts, seed, burn, thin, n_samples,
            iteration_offset, n_chains, samples.data_ptr(), lps.data_ptr(),
            accs.data_ptr(), torch.cuda.current_stream(p.device).cuda_stream,
        )
    _build.check(lib, code, "rwmh", cuda_density, d)
    fused_rwmh_sample.launches += 1
    return samples, lps, accs


def fused_rwmh(
    tile_fn: Callable, cuda_density: Optional[str], params_t: torch.Tensor,
    lp: torch.Tensor, scale, consts: Sequence[torch.Tensor], seed: int, *,
    n_steps: int, iteration_offset: int = 0,
):
    """``n_steps`` RWMH steps in one launch (≙ pallas_mh.py::fused_rwmh).

    Returns params ``(d, C)``, lp ``(1, C)`` and accept counts ``(1, C)``."""
    _check(params_t, lp, consts, (n_steps,))
    if params_t.device.type == "cpu":
        return rwmh_reference(
            tile_fn, cuda_density, params_t, lp, scale, consts, seed,
            n_steps=n_steps, iteration_offset=iteration_offset,
        )
    lib, tril, p, l, s, flat, n_consts = _cuda_args(
        params_t, lp, scale, consts, seed, iteration_offset)
    d, n_chains = p.shape
    out_p = torch.empty_like(p)
    out_l = torch.empty_like(l)
    out_a = torch.empty_like(l)
    with torch.cuda.device(p.device):
        code = lib.amh_rwmh(
            _build.density_arg(cuda_density), d, int(tril), p.data_ptr(), l.data_ptr(), s.data_ptr(),
            flat.data_ptr(), n_consts, seed, n_steps, iteration_offset, n_chains,
            out_p.data_ptr(), out_l.data_ptr(), out_a.data_ptr(),
            torch.cuda.current_stream(p.device).cuda_stream,
        )
    _build.check(lib, code, "rwmh", cuda_density, d)
    fused_rwmh.launches += 1
    return out_p, out_l, out_a


fused_rwmh_sample.launches = 0
fused_rwmh.launches = 0
