"""The ``fixture_gp`` configuration: its data from the seed, the program's
model of it and the prior its sampler takes (``program_objects``), and its
plain reference (``reference/fixture_gp.py``, stepped by ``reference/ess.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import ess
from portbench.reference import fixture_gp as ref


def make_data(cfg, seed: int, device) -> dict:
    """The prior's factor (float64) and observations of a draw from it."""
    L = ref.prior_tril(cfg)
    rng = np.random.default_rng(seed)
    n = int(cfg["n_points"])
    f_true = L @ torch.from_numpy(rng.normal(size=n))
    y = f_true + cfg["noise"] * torch.from_numpy(rng.normal(size=n))
    return {"tril": L.to(device), "y": y.to(torch.float32).to(device)}


def program_model(cfg, data: dict, device):
    from advancedmh_tpu_torch.models import TileDensityModel, gp_regression_tile

    y, noise = data["y"], float(cfg["noise"])
    n = y.numel()
    inv2, norm = 1.0 / (noise * noise), n * (0.5 * math.log(2.0 * math.pi) + math.log(noise))
    full = lambda v: torch.full((1, 1), v, dtype=torch.float32, device=device)  # noqa: E731

    def loglik(f):
        r = y - f
        return -0.5 * inv2 * torch.sum(r * r, dim=-1) - norm

    return TileDensityModel(logdensity_fn=loglik, dimension=n, logdensity_batched_fn=loglik,
                            device=device, tile_density=gp_regression_tile,
                            tile_consts=(y.reshape(-1, 1), full(inv2), full(norm)),
                            cuda_density="gp_regression")


def program_objects(cfg, data: dict, device) -> dict:
    """``prior``: the program's MvNormal(0, scale_tril = L) in float32."""
    from advancedmh_tpu_torch import MvNormal

    L = data["tril"].to(torch.float32)
    return {"prior": MvNormal(torch.zeros(L.shape[0], dtype=torch.float32, device=device),
                              scale_tril=L)}


def reference_logp(cfg, data: dict, dtype):
    y = data["y"].to(dtype)
    return ess.Target(lambda f: ref.loglik(f.to(dtype), y, float(cfg["noise"])),
                      torch.zeros(y.numel(), dtype=dtype, device=y.device),
                      data["tril"].to(dtype))
