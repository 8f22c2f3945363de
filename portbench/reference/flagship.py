"""Plain reference of the ``flagship`` configuration: the AdvancedMH.jl
README's Normal(μ, σ) model over its observations, with the support guard
of the port's ``models/targets.py::gaussian_mean_scale_model`` (commit
63ce544): a flat prior, ``-inf`` where σ < 0, and σ read as max(σ, 0.1)
inside the density (the guard's safe parameters).

    log p(μ, σ) = Σᵢ −½((yᵢ − μ)/s)² − n log s − (n/2) log 2π,  s = max(σ, 0.1)

Plain PyTorch in the dtype of its inputs; imports nothing of the program.
"""
from __future__ import annotations

import math

import torch


def logp(x: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Log density of points ``x`` (M, 2) given the observations (n,)."""
    mu, sigma = x[:, 0:1], x[:, 1:2]
    s = torch.clamp(sigma, min=0.1)
    z = (obs.reshape(1, -1).to(x.dtype) - mu) / s
    n = obs.numel()
    lp = (-0.5 * z * z).sum(dim=1) - n * torch.log(s[:, 0]) - n * 0.5 * math.log(2.0 * math.pi)
    return torch.where(sigma[:, 0] >= 0, lp, torch.full_like(lp, -math.inf))
