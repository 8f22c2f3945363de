"""Sample bundling (≙ advancedmh_tpu/output/bundle.py): ``Chains``, the
columnar ``StructArray`` and the single-chain list of dicts."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .chains import Chains
from .flatten import flatten_params


def bundle_chains(result, param_names: Optional[Sequence[str]] = None) -> Chains:
    params = result.transitions.params
    lp = result.transitions.lp
    sched = result.schedule
    if result.num_chains is None:
        values, names = flatten_params(params, 1, param_names)  # (S, P)
        values = values[:, :, None]
        lp = lp[:, None]
    else:
        # (C, S, *ev) → (S, P, C)
        values, names = flatten_params(params, 2, param_names)  # (C, S, P)
        values = values.permute(1, 2, 0)
        lp = lp.T
    return Chains(values, lp, names, start=sched.start, thin=sched.thinning)


class StructArray(dict):
    """Columnar struct-of-arrays view (≙ StructArrays.StructArray): a dict of
    per-parameter draw tensors with attribute access, plus ``lp``."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @staticmethod
    def cat(*arrays: "StructArray") -> "StructArray":
        out = StructArray()
        for k in arrays[0]:
            out[k] = torch.cat([a[k] for a in arrays], dim=-1)
        return out


def _sanitize(name: str) -> str:
    return name.replace("[", "_").replace("]", "").replace(".", "_")


def bundle_structarray(result, param_names: Optional[Sequence[str]] = None) -> StructArray:
    """Each parameter → its draws with all batch axes, plus ``lp``."""
    sample_ndim = 1 + (result.num_chains is not None)
    values, names = flatten_params(result.transitions.params, sample_ndim, param_names)
    out = StructArray()
    for i, name in enumerate(names):
        out[_sanitize(name)] = values[..., i]
    out["lp"] = result.transitions.lp
    return out


def chainscat(*bundles):
    """≙ ``AbstractMCMC.chainscat``."""
    first = bundles[0]
    if isinstance(first, Chains):
        return Chains.cat(*bundles)
    if isinstance(first, StructArray):
        return StructArray.cat(*bundles)
    raise TypeError(f"chainscat: unsupported bundle type {type(first).__name__}")


def bundle_namedtuples(result, param_names: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    """Host-side list of per-sample dicts (single chain only)."""
    if result.num_chains is not None:
        raise ValueError(
            "bundle_namedtuples is the single-chain scalar format; use "
            "to_chains()/to_structarray() for batched runs."
        )
    values, names = flatten_params(result.transitions.params, 1, param_names)
    names = [_sanitize(n) for n in names]
    rows = values.detach().cpu().to(torch.float64).numpy().tolist()
    lps = np.asarray(result.transitions.lp.detach().cpu(), np.float64).tolist()
    return [dict(zip(names, row), lp=l) for row, l in zip(rows, lps)]
