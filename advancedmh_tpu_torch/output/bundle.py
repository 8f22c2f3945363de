"""Sample bundling (≙ advancedmh_tpu/output/bundle.py): ``Chains``, the
columnar ``StructArray`` and the single-chain list of dicts."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.trace import traced
from .chains import Chains
from .flatten import flatten_params


def _is_ensemble(result) -> bool:
    """Population samplers (emcee's Ensemble) carry a leading walker axis,
    bundled into the reference's 3-D walker array
    (ext/AdvancedMHMCMCChainsExt.jl:80-121)."""
    return bool(getattr(result.sampler, "is_population", False))


@traced("bundle")
def bundle_chains(result, param_names: Optional[Sequence[str]] = None) -> Chains:
    params = result.transitions.params
    lp = result.transitions.lp
    sched = result.schedule
    C, ensemble = result.num_chains, _is_ensemble(result)
    if C is None and not ensemble:
        values, names = flatten_params(params, 1, param_names)  # (S, P)
        values = values[:, :, None]
        lp = lp[:, None]
    elif C is None:
        # (S, W, *ev) → (S, P, W); lp is already (S, W)
        values, names = flatten_params(params, 2, param_names)  # (S, W, P)
        values = values.permute(0, 2, 1)
    elif not ensemble:
        # (C, S, *ev) → (S, P, C)
        values, names = flatten_params(params, 2, param_names)  # (C, S, P)
        values = values.permute(1, 2, 0)
        lp = lp.T
    else:
        # (C, S, W, *ev) → (S, P, C*W)
        values, names = flatten_params(params, 3, param_names)  # (C, S, W, P)
        c, s, w, p = values.shape
        values = values.permute(1, 3, 0, 2).reshape(s, p, c * w)
        lp = lp.permute(1, 0, 2).reshape(s, c * w)
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
    sample_ndim = 1 + (result.num_chains is not None) + _is_ensemble(result)
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
    if result.num_chains is not None or _is_ensemble(result):
        raise ValueError(
            "bundle_namedtuples is the single-chain scalar format; use "
            "to_chains()/to_structarray() for batched runs."
        )
    values, names = flatten_params(result.transitions.params, 1, param_names)
    names = [_sanitize(n) for n in names]
    rows = values.detach().cpu().to(torch.float64).numpy().tolist()
    lps = np.asarray(result.transitions.lp.detach().cpu(), np.float64).tolist()
    return [dict(zip(names, row), lp=l) for row, l in zip(rows, lps)]
