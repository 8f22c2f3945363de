"""Parameter trees: nested dicts, tuples and lists of tensors.

≙ the ``jax.tree_util`` calls of the JAX package. Only the three container
kinds the proposal algebra uses are trees here; everything else (tensors,
numbers, distributions, proposals) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch


def _children(x) -> Optional[List[Tuple[Any, Any]]]:
    """(path key, child) pairs of a container, or None for a leaf."""
    if isinstance(x, dict):
        return list(x.items())
    if isinstance(x, (tuple, list)):
        return list(enumerate(x))
    return None


def _rebuild(template, children: List[Any]):
    if isinstance(template, dict):
        return dict(zip(template.keys(), children))
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*children)  # namedtuple
    return type(template)(children)


def _kids(x, is_leaf):
    return None if (is_leaf is not None and is_leaf(x)) else _children(x)


# The walks below are module-level functions on explicit arguments: a nested
# function that calls itself is a reference cycle (it sits in its own
# closure), and the cycle would keep the tensors it collects alive until the
# cyclic garbage collector runs, which device memory does not trigger.


def _walk(x, path, is_leaf, out) -> None:
    kids = _kids(x, is_leaf)
    if kids is None:
        out.append((path, x))
        return
    for k, v in kids:
        _walk(v, path + (k,), is_leaf, out)


def _build(x, it, is_leaf):
    kids = _kids(x, is_leaf)
    if kids is None:
        return next(it)
    return _rebuild(x, [_build(v, it, is_leaf) for _, v in kids])


def tree_flatten_with_path(tree, is_leaf: Optional[Callable] = None):
    """Leaves of ``tree`` in order, each with its path of dict keys and
    sequence indices, plus a function that rebuilds the tree from leaves."""
    leaves: List[Tuple[tuple, Any]] = []
    _walk(tree, (), is_leaf, leaves)

    def unflatten(new_leaves):
        return _build(tree, iter(new_leaves), is_leaf)

    return leaves, unflatten


def tree_flatten(tree, is_leaf: Optional[Callable] = None):
    leaves, unflatten = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in leaves], unflatten


def _walk_up_to(s, t, is_leaf, out) -> None:
    kids = _kids(s, is_leaf)
    if kids is None:
        out.append(t)
        return
    t_kids = _children(t)
    if t_kids is None or len(t_kids) != len(kids):
        raise ValueError("tree does not match the proposal's structure")
    if isinstance(s, dict):
        for k, v in kids:
            _walk_up_to(v, t[k], is_leaf, out)
    else:
        for (_, v), (_, tv) in zip(kids, t_kids):
            _walk_up_to(v, tv, is_leaf, out)


def flatten_up_to(structure, tree, is_leaf: Optional[Callable] = None) -> list:
    """Leaves of ``tree`` at the positions of ``structure``'s leaves (the
    subtrees of ``tree`` below them stay whole)."""
    out: list = []
    _walk_up_to(structure, tree, is_leaf, out)
    return out


def leaves_to_matrix(leaves, batch_shape) -> torch.Tensor:
    """Chain-batched leaves as one (B, D) matrix: B = the batch's size (1
    for one chain), each leaf's event entries side by side in leaf order."""
    B = int(np.prod(batch_shape)) if batch_shape else 1
    return torch.cat([leaf.reshape(B, -1) for leaf in leaves], dim=1)


def matrix_to_leaves(mat, like, batch_shape) -> list:
    """The inverse of :func:`leaves_to_matrix`, shaped as the leaves ``like``."""
    out, k = [], 0
    for leaf in like:
        n = int(np.prod(leaf.shape[len(batch_shape):]))
        out.append(mat[:, k:k + n].reshape(leaf.shape))
        k += n
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    leaves, unflatten = tree_flatten(tree, is_leaf)
    rest_leaves = [flatten_up_to(tree, r, is_leaf) for r in rest]
    return unflatten(
        [fn(x, *(rl[i] for rl in rest_leaves)) for i, x in enumerate(leaves)]
    )
