"""The kernels' noise, worked out again: Philox4x32-10 at counter (step,
chain, sub-block), uniforms from its words and Box-Muller normals.

Copied from ``advancedmh_tpu_torch/ops/rwmh.py`` (``_mulhilo32``,
``philox4x32_reference``, ``uniform_from_bits``, ``box_muller``) and
``advancedmh_tpu_torch/utils/keys.py`` (``splitmix64``, ``fold_in``) at
commit 63ce544, and generalised to any set of (step, chain) pairs. The
uniforms are exact in float64 as in float32; the logs, roots and sines are
taken in the caller's dtype. Plain PyTorch; imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def splitmix64(x: int) -> int:
    z = (x + _GOLDEN) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    return splitmix64((key & MASK64) ^ splitmix64(int(data) & MASK64))


def kernel_seed(key: int) -> int:
    """The 64-bit Philox seed the kernels use for a sample() key."""
    return splitmix64(key & MASK64)


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = b_lo * a_lo
    lh = b_hi * a_lo
    hl = b_lo * a_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = b_hi * a_hi + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox(counter: torch.Tensor, seed: int) -> torch.Tensor:
    """Philox4x32-10 of int64 counter words ``(..., 4)``; int64 words out."""
    c0, c1, c2, c3 = (w & MASK32 for w in counter.unbind(-1))
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W[0]) & MASK32
            k1 = (k1 + _PHILOX_W[1]) & MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def uniforms(seed: int, step: torch.Tensor, chain: torch.Tensor, n_words: int,
             dtype=torch.float64) -> torch.Tensor:
    """Words ``0 .. n_words-1`` of (absolute step, chain) pairs as uniforms
    in (0, 1), ``(M, n_words)``: word w is element w % 4 of sub-block w / 4
    of counter (low word of step, chain, sub-block, high word of step)."""
    n_sub = (n_words + 3) // 4
    j = step.to(torch.int64).reshape(-1, 1)
    c = chain.to(torch.int64).reshape(-1, 1)
    s = torch.arange(n_sub, dtype=torch.int64, device=step.device).reshape(1, -1)
    shape = (j.shape[0], n_sub)
    counter = torch.stack([(j & MASK32).expand(shape), c.expand(shape), s.expand(shape),
                           (j >> 32).expand(shape)], dim=-1)
    words = philox(counter, seed).reshape(j.shape[0], 4 * n_sub)[:, :n_words]
    return (words & 0x7FFFFF).to(dtype) * 2.0**-23 + 2.0**-24


def step_noise(seed: int, step: torch.Tensor, chain: torch.Tensor, d: int,
               dtype=torch.float64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The d normals ``(M, d)`` (pair p from words 2p, 2p + 1: r cos θ,
    r sin θ) and log u of the accept uniform (word 2P) ``(M,)`` of each
    (step, chain) pair."""
    pairs = (d + 1) // 2
    u = uniforms(seed, step, chain, 2 * pairs + 1, dtype)
    r = torch.sqrt(-2.0 * torch.log(u[:, 0:2 * pairs:2]))
    theta = (2.0 * math.pi) * u[:, 1:2 * pairs:2]
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    return z.reshape(-1, 2 * pairs)[:, :d], torch.log(u[:, 2 * pairs])


class NoiseStream:
    """The noise of consecutive steps of chains ``chain`` (M,), from
    absolute steps ``first`` (M,) on: ``next()`` returns the next step's
    normals (M, d), log u (M,) and absolute steps (M,). Philox runs on
    ``chunk`` steps at once."""

    def __init__(self, seed: int, chain: torch.Tensor, first: torch.Tensor, d: int,
                 dtype=torch.float64, chunk: int = 1):
        self.seed, self.chain, self.d, self.dtype = seed, chain, d, dtype
        self.first = first.to(torch.int64).reshape(-1)
        self.chunk = max(1, int(chunk))
        self.t = 0
        self.buf = None

    def next(self):
        i = self.t % self.chunk
        if i == 0:
            M = self.chain.numel()
            ts = torch.arange(self.t, self.t + self.chunk, device=self.first.device)
            steps = (self.first.reshape(1, M) + ts.reshape(-1, 1)).reshape(-1)
            z, logu = step_noise(self.seed, steps, self.chain.repeat(self.chunk), self.d,
                                 self.dtype)
            self.buf = (z.reshape(self.chunk, M, self.d), logu.reshape(self.chunk, M),
                        steps.reshape(self.chunk, M))
        self.t += 1
        return self.buf[0][i], self.buf[1][i], self.buf[2][i]
