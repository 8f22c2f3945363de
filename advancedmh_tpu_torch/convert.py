"""Carry the JAX package's state across, as numpy arrays.

Functions here take numpy arrays (never JAX objects) and return the port's
objects on a given device, so one set of inputs can be handed to both
packages: model data, proposal scales, and a ``Transition``'s
``(params, lp, accepted)`` for ``initial_params`` / ``initial_state``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .distributions import MvNormal
from .models.targets import TileDensityModel, gaussian_mean_scale_model
from .samplers.base import Transition


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def gaussian_mean_scale_from_numpy(data: np.ndarray, device="cpu") -> TileDensityModel:
    """The (μ, σ) flagship model on the observations ``data``."""
    return gaussian_mean_scale_model(data=np.asarray(data, np.float32), device=device)


def mvnormal_from_numpy(
    loc: np.ndarray,
    scale: Optional[float] = None,
    scale_diag: Optional[np.ndarray] = None,
    scale_tril: Optional[np.ndarray] = None,
    device="cpu",
) -> MvNormal:
    """An MvNormal with one of the three scale forms."""
    kw = {}
    if scale_tril is not None:
        kw["scale_tril"] = _f32(scale_tril, device)
    elif scale_diag is not None:
        kw["scale_diag"] = _f32(scale_diag, device)
    elif scale is not None:
        kw["scale"] = float(scale)
    return MvNormal(loc=_f32(loc, device), **kw)


def transition_from_numpy(
    params: np.ndarray, lp: np.ndarray, accepted: np.ndarray, device="cpu"
) -> Transition:
    """A Transition (single chain or chain-batched) from its three arrays."""
    return Transition(
        _f32(params, device),
        _f32(lp, device),
        torch.as_tensor(np.asarray(accepted, bool), device=device),
    )
