"""Prebuilt target models (≙ advancedmh_tpu/models/targets.py; only the
reference README flagship in this slice).

A model that the fused engine can run carries, besides its per-chain
density, a *tile* density over the transposed chain block ``(d, C) ->
(1, C)`` (the plain version of the kernel's density), the constants that
tile density reads, and ``cuda_density``: the name of the device function
in ``csrc/rwmh.cu`` that the kernels instantiate for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..distributions import Normal
from .density import DensityModel, guarded_logdensity

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class TileDensityModel(DensityModel):
    """A DensityModel with a tile density for the fused engine."""

    tile_density: Optional[Callable] = None
    tile_consts: Tuple[torch.Tensor, ...] = ()
    cuda_density: Optional[str] = None


def gaussian_mean_scale_tile(p: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Tile density of the (μ, σ) model: ``p`` (2, C), ``obs`` (n, 1).

    One reciprocal per chain instead of n divides; ``-inf`` where σ < 0.
    The CUDA device function ``GaussianMeanScale`` in ``csrc/rwmh.cu`` does
    the same algebra.
    """
    n = obs.shape[0]
    mu, sigma = p[0:1], p[1:2]
    inv = 1.0 / torch.clamp(sigma, min=0.1)
    z = (obs - mu) * inv
    lp = (
        torch.sum(-0.5 * z * z, dim=0, keepdim=True)
        + n * torch.log(inv)
        - n * _HALF_LOG_2PI
    )
    return torch.where(sigma >= 0, lp, torch.full_like(lp, -torch.inf))


def gaussian_mean_scale_model(
    data=None, n_obs: int = 30, seed: int = 1234, device="cpu"
) -> TileDensityModel:
    """The reference README/test flagship: θ = (μ, σ) posterior of a Normal
    with a σ ≥ 0 support guard (reference README.md:23-40 and
    test/runtests.jl:22-31). ``data`` defaults to the JAX package's 30
    observations, ``np.random.default_rng(1234).normal(size=30)``."""
    if data is None:
        data = np.random.default_rng(seed).normal(size=n_obs)
    data = torch.as_tensor(np.asarray(data, np.float32), device=device)
    obs = data.reshape(-1, 1)

    def density(theta):
        return torch.sum(Normal(theta[0], theta[1]).log_prob(data))

    ld = guarded_logdensity(
        support_fn=lambda t: t[1] >= 0,
        logdensity_fn=density,
        safe_params_fn=lambda t: torch.stack([t[0], torch.clamp(t[1], min=0.1)]),
    )
    return TileDensityModel(
        logdensity_fn=ld,
        dimension=2,
        logdensity_batched_fn=lambda theta: gaussian_mean_scale_tile(theta.T, obs)[0],
        device=device,
        tile_density=gaussian_mean_scale_tile,
        tile_consts=(obs,),
        cuda_density="gaussian_mean_scale",
    )
