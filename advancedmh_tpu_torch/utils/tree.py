"""Parameter trees: nested dicts, tuples and lists of tensors.

≙ the ``jax.tree_util`` calls of the JAX package. Only the three container
kinds the proposal algebra uses are trees here; everything else (tensors,
numbers, distributions, proposals) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


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


def tree_flatten_with_path(tree, is_leaf: Optional[Callable] = None):
    """Leaves of ``tree`` in order, each with its path of dict keys and
    sequence indices, plus a function that rebuilds the tree from leaves."""
    leaves: List[Tuple[tuple, Any]] = []

    def walk(x, path):
        kids = None if (is_leaf is not None and is_leaf(x)) else _children(x)
        if kids is None:
            leaves.append((path, x))
            return
        for k, v in kids:
            walk(v, path + (k,))

    walk(tree, ())

    def unflatten(new_leaves):
        it = iter(new_leaves)

        def build(x):
            kids = None if (is_leaf is not None and is_leaf(x)) else _children(x)
            if kids is None:
                return next(it)
            return _rebuild(x, [build(v) for _, v in kids])

        return build(tree)

    return leaves, unflatten


def tree_flatten(tree, is_leaf: Optional[Callable] = None):
    leaves, unflatten = tree_flatten_with_path(tree, is_leaf)
    return [leaf for _, leaf in leaves], unflatten


def flatten_up_to(structure, tree, is_leaf: Optional[Callable] = None) -> list:
    """Leaves of ``tree`` at the positions of ``structure``'s leaves (the
    subtrees of ``tree`` below them stay whole)."""
    out: list = []

    def walk(s, t):
        kids = None if (is_leaf is not None and is_leaf(s)) else _children(s)
        if kids is None:
            out.append(t)
            return
        t_kids = _children(t)
        if t_kids is None or len(t_kids) != len(kids):
            raise ValueError("tree does not match the proposal's structure")
        if isinstance(s, dict):
            for k, v in kids:
                walk(v, t[k])
        else:
            for (_, v), (_, tv) in zip(kids, t_kids):
                walk(v, tv)

    walk(structure, tree)
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    leaves, unflatten = tree_flatten(tree, is_leaf)
    rest_leaves = [flatten_up_to(tree, r, is_leaf) for r in rest]
    return unflatten(
        [fn(x, *(rl[i] for rl in rest_leaves)) for i, x in enumerate(leaves)]
    )
