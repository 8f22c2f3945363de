"""The ``flagship`` configuration: its data from the seed, the program's
model of it, and its plain reference (``reference/flagship.py``)."""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference import flagship as ref


def make_data(cfg, seed: int, device) -> dict:
    """The configuration's 30 observations, permuted by ``seed``."""
    obs = np.random.default_rng(cfg["data_seed"]).normal(size=cfg["n_obs"])
    perm = np.random.default_rng(seed).permutation(cfg["n_obs"])
    return {"obs": torch.tensor(obs[perm], dtype=torch.float32, device=device)}


def program_model(cfg, data: dict, device):
    from advancedmh_tpu_torch.models.targets import gaussian_mean_scale_model

    return gaussian_mean_scale_model(data=data["obs"].cpu().numpy(), device=device)


def reference_logp(cfg, data: dict, dtype):
    obs = data["obs"].to(dtype)
    return lambda x: ref.logp(x.to(dtype), obs)
