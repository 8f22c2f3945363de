"""Flatten params trees into named parameter matrices
(≙ advancedmh_tpu/output/flatten.py): vector params become
``param_1..param_d``, dict params use their keys, ``param_names`` override."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.tree import tree_flatten_with_path


def _path_name(path) -> str:
    return "_".join(str(p) if isinstance(p, str) else str(p + 1) for p in path)


def flatten_params(
    params, sample_ndim: int, param_names: Optional[Sequence[str]] = None
) -> Tuple[torch.Tensor, List[str]]:
    """Flatten a params tree (leading ``sample_ndim`` batch axes per leaf)
    into ``(values, names)`` with ``values`` of shape ``(*batch, P)``."""
    arrays = []
    names: List[str] = []
    for path, leaf in tree_flatten_with_path(params)[0]:
        leaf = torch.as_tensor(leaf)
        event_size = 1
        for s in leaf.shape[sample_ndim:]:
            event_size *= s
        arrays.append(leaf.reshape(tuple(leaf.shape[:sample_ndim]) + (event_size,)))
        base = _path_name(path)
        if event_size == 1 and leaf.ndim == sample_ndim:
            names.append(base if base else "param_1")
        elif base:
            names.extend(
                [base] if event_size == 1 else [f"{base}[{i+1}]" for i in range(event_size)]
            )
        else:
            names.extend([f"param_{i+1}" for i in range(event_size)])
    values = arrays[0] if len(arrays) == 1 else torch.cat(arrays, dim=-1)
    if param_names is not None:
        param_names = list(param_names)
        if len(param_names) != values.shape[-1]:
            raise ValueError(
                f"param_names has {len(param_names)} entries for "
                f"{values.shape[-1]} parameters."
            )
        names = param_names
    return values, names
