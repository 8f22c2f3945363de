"""What every kernel's plain version shares (≙ csrc/philox.cuh and
csrc/common.cuh): Philox4x32-10 in plain PyTorch, the noise the kernels draw
from it, and the kernels' order of arithmetic.

Random numbers come from Philox4x32-10 with key = the seed's two 32-bit
words and counter = (low word of j, chain, sub-block, high word of j), j the
absolute step index (``iteration_offset + 1`` is the first step of a call).
The noise of a step therefore depends only on (seed, j, chain), and a plain
version draws the same normals and uniforms as its kernel, up to the last
ulp of log / sin / cos.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

TWO_PI = 6.283185307179586
MASK32 = 0xFFFFFFFF
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
    c0, c1, c2, c3 = (w & MASK32 for w in counter.unbind(-1))
    k0, k1 = int(key[0]) & MASK32, int(key[1]) & MASK32
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W[0]) & MASK32
            k1 = (k1 + _PHILOX_W[1]) & MASK32
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
        [(j & MASK32).expand(shape), c.expand(shape), s.expand(shape),
         (j >> 32).expand(shape)],
        dim=-1,
    )
    key = (seed & MASK32, (seed >> 32) & MASK32)
    words = philox4x32_reference(counter, key).reshape(n, n_chains, 4 * n_sub)
    return uniform_from_bits(words[..., :n_words])


def box_muller(u: torch.Tensor, d: int) -> torch.Tensor:
    """The d normals of uniforms ``(n, C, W)``: pair p from words 2p and
    2p+1, as ``(n, d, C)`` (csrc/common.cuh::step_normals)."""
    n, n_chains = u.shape[:2]
    pairs = (d + 1) // 2
    u1, u2 = u[..., 0 : 2 * pairs : 2], u[..., 1 : 2 * pairs : 2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI * u2
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


def noise_chunk(n_chains: int, n_words: int = 4) -> int:
    """Steps of noise made per vectorized call: about 2²² Philox blocks of
    ``n_words`` words each chain-step."""
    return max(1, (1 << 22) // max(1, n_chains * ((n_words + 3) // 4)))


# ---- the kernels' order of arithmetic -------------------------------------


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


def perturb(scale: torch.Tensor, tril: bool, z: torch.Tensor) -> torch.Tensor:
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


def f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (a kernel argument)."""
    return float(np.float32(v))


def check_block(params_t, lp, consts, d_counts: Sequence[int]) -> None:
    """The (d, C) chain block, its (1, C) lp and the density's constants on
    one device, and non-negative step counts."""
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


def rw_launch_args(params_t, lp, scale, consts, seed: int, iteration_offset: int):
    """A random-walk kernel's launch inputs (RWMH, MTM): (tril, params,
    lp, scale, constants, their count), after :func:`_build.check_cuda_launch`."""
    _build.check_cuda_launch(params_t, seed, iteration_offset)
    scale_arr, tril = scale_block(scale, params_t.shape[0], params_t.device)
    flat, n_consts = _build.flat_consts(consts, params_t.device)
    return tril, params_t.contiguous(), lp.contiguous(), scale_arr, flat, n_consts
