"""Cross-chain sums in the order the pooling kernels take them.

The ChEES warmup and MEADS kernels (``csrc/chees.cu``, ``csrc/meads.cu``)
pool statistics over a tile of chains on every step. In the ChEES warmup a
tile spans several blocks of ``POOL_BLOCK`` threads; the sum of a per-thread
quantity is taken in two stages (``csrc/pooling.cuh``):

1. in each block, a halving tree over its threads: at each level thread
   ``i < s`` adds thread ``i + s``'s value, ``s = B/2, B/4, .., 1``;
2. over the tile, the block partials in block order, one after another.

Threads past the end of the tile add 0. MEADS runs a tile in one cluster of
blocks and sums each block's positions in order, then the blocks in order
(:func:`cluster_sum`). No atomics: the order is fixed, so a kernel's sums are
repeatable and these plain versions give the same bits.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

POOL_BLOCK = 64  # threads per block of the pooling kernels (pooling.cuh::kPoolBlock)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Halving-tree sum over the last axis (a power of two long)."""
    n = v.shape[-1]
    while n > 1:
        n //= 2
        v = v[..., :n] + v[..., n:2 * n]
    return v[..., 0]


def seq_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in order, one element after another."""
    acc = v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i]
    return acc


def pooled_sum(v: torch.Tensor, block: int = POOL_BLOCK) -> torch.Tensor:
    """The kernels' sum of ``v`` (..., n) over its n threads: a tree in each
    block of ``block`` threads, then the blocks in order."""
    n = v.shape[-1]
    nb = -(-n // block)
    v = F.pad(v, (0, nb * block - n))
    return seq_sum(tree_sum(v.reshape(*v.shape[:-1], nb, block)))


def cluster_sum(v: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """The MEADS kernel's sum of ``v`` (..., F) over F fold positions split
    among the ``n_blocks`` blocks of a cluster, ``P = ceil(F / n_blocks)``
    each (the last ones short, padded with 0): each block's P in order, then
    the blocks' partials in block order (``csrc/meads.cu``)."""
    F_ = v.shape[-1]
    P = -(-F_ // n_blocks)
    v = F.pad(v, (0, n_blocks * P - F_))
    return seq_sum(seq_sum(v.reshape(*v.shape[:-1], n_blocks, P)))


def tile_groups(n_chains: int, tile: int) -> List[Tuple[int, int, int]]:
    """The chain tiles as (first chain, number of tiles, tile size) groups:
    the full tiles, then the short last tile if there is one."""
    n_full, rest = divmod(n_chains, tile)
    groups = [(0, n_full, tile)] if n_full else []
    if rest:
        groups.append((n_full * tile, 1, rest))
    return groups


def n_blocks(n_chains: int, tile: int, per_tile=lambda size: size) -> int:
    """Blocks of a pooling launch: each tile takes ceil(threads / POOL_BLOCK)
    blocks of its own, ``per_tile(size)`` threads for a tile of ``size``
    chains."""
    return sum(n_t * -(-per_tile(size) // POOL_BLOCK)
               for _, n_t, size in tile_groups(n_chains, tile))


def tile_sums(v: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile pooled sums of per-chain quantities ``v`` (Q, C): (Q, n_tiles)."""
    Q, C = v.shape
    out = []
    for start, n_t, size in tile_groups(C, tile):
        seg = v[:, start:start + n_t * size].reshape(Q, n_t, size)
        out.append(pooled_sum(seg))
    return torch.cat(out, dim=1)


def per_chain(values: torch.Tensor, tile: int, n_chains: int) -> torch.Tensor:
    """Per-tile values (..., n_tiles) repeated over each tile's chains."""
    sizes = torch.tensor([size for _, n_t, size in tile_groups(n_chains, tile)
                          for _ in range(n_t)], device=values.device)
    return torch.repeat_interleave(values, sizes, dim=-1)


def nan_max(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.maximum``: NaN if either side is NaN."""
    return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def nan_min(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.minimum``: NaN if either side is NaN."""
    return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def full(like: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` as a tensor shaped like ``like``: the plain versions divide
    tensor by tensor, one rounding, as the kernels do (PyTorch divides a
    tensor by a Python number as a product with its reciprocal)."""
    return torch.full_like(like, v)
