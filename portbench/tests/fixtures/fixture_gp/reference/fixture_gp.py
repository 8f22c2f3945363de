"""Plain reference of the ``fixture_gp`` configuration: the Gaussian-process
regression latent field of ``models/targets.py::gp_latent_model``, restated.

    K_ij = a² exp(−½ (x_i − x_j)² / ℓ²) + jitter·δ_ij,  x = linspace(0, 1, n),
    log L(f) = −½ Σᵢ (yᵢ − fᵢ)² / s² − n (½ log 2π + log s)

Plain PyTorch in the dtype of its inputs; imports nothing of the program.
"""
from __future__ import annotations

import math

import torch


def prior_tril(cfg: dict) -> torch.Tensor:
    """The lower Cholesky factor of the prior's covariance K, float64."""
    x = torch.linspace(0.0, 1.0, int(cfg["n_points"]), dtype=torch.float64)
    sq = (x[:, None] - x[None, :]) ** 2
    K = cfg["amplitude"] ** 2 * torch.exp(-0.5 * sq / cfg["lengthscale"] ** 2)
    K = K + cfg["jitter"] * torch.eye(x.numel(), dtype=torch.float64)
    return torch.linalg.cholesky(K)


def loglik(f: torch.Tensor, y: torch.Tensor, noise: float) -> torch.Tensor:
    """Log-likelihood of latent fields ``f`` (M, n) given observations ``y`` (n,)."""
    r = y.reshape(1, -1).to(f.dtype) - f
    n = y.numel()
    return -0.5 * (r * r).sum(dim=1) / noise**2 - n * (0.5 * math.log(2.0 * math.pi)
                                                       + math.log(noise))
