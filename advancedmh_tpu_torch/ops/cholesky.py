"""Rank-1 Cholesky update/downdate (≙ advancedmh_tpu/ops/cholesky.py).

Given lower-triangular ``L`` with ``A = L Lᵀ`` and a vector ``v``, returns
the factor of ``A + sign·v vᵀ`` by the O(d²) column sweep (a Givens rotation
for an update, a hyperbolic one for a downdate, one formula in ``sign`` so a
per-chain sign needs no branch). A downdate that loses positive-definiteness
is reported by the ``ok`` flag instead of an exception; RAM then keeps its
old factor.

One form of the sweep is ported: a loop over the d columns, each step a
masked full-column tensor operation over any leading batch axes. (The JAX
package also unrolls small d; its crossover is a TPU constant.)
"""
from __future__ import annotations

from typing import Tuple

import torch


def chol_rank1_update_batched(
    L: torch.Tensor, v: torch.Tensor, sign
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (L', ok) with L' L'ᵀ = L Lᵀ + sign·v vᵀ over leading batch
    axes: L (..., d, d), v (..., d), sign (...) or a scalar; ok (...)."""
    d = L.shape[-1]
    batch = L.shape[:-2]
    sign = torch.as_tensor(sign, dtype=L.dtype, device=L.device).expand(batch)[..., None]
    tiny = torch.tensor(torch.finfo(L.dtype).tiny, dtype=L.dtype, device=L.device)
    rows = torch.arange(d, device=L.device)
    L = L.clone()
    ok = torch.ones(batch, dtype=torch.bool, device=L.device)
    for k in range(d):
        col = L[..., :, k]
        Lkk = col[..., k : k + 1]
        vk = v[..., k : k + 1]
        r2 = Lkk * Lkk + sign * vk * vk
        ok = ok & (r2[..., 0] > 0)
        r = torch.sqrt(torch.maximum(r2, tiny))
        c = r / Lkk
        s = vk / Lkk
        below = rows > k
        newcol = torch.where(below, (col + sign * s * v) / c, col)
        newcol = torch.where(rows == k, r, newcol)
        L[..., :, k] = newcol
        v = torch.where(below, c * v - s * newcol, v)
    return L, ok


def chol_rank1_update(
    L: torch.Tensor, v: torch.Tensor, sign
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (L', ok) with L' L'ᵀ = L Lᵀ + sign·v vᵀ for one (d, d) factor;
    ``sign`` is +1, −1 or 0 (a no-op), ``ok`` a 0-dim bool."""
    return chol_rank1_update_batched(L, v, sign)
