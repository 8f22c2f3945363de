"""Univariate distributions (≙ advancedmh_tpu/distributions/univariate.py;
``Normal`` only in this slice)."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .base import Distribution, as_param

_LOG_2PI = math.log(2.0 * math.pi)


def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else ()


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def sample(self, gen, sample_shape: Tuple[int, ...] = ()):
        shape = tuple(sample_shape) + tuple(
            torch.broadcast_shapes(_shape(self.loc), _shape(self.scale))
        )
        eps = torch.randn(shape, generator=gen, device=gen.device)
        return as_param(self.loc, eps) + as_param(self.scale, eps) * eps

    def log_prob(self, x):
        x = torch.as_tensor(x, dtype=torch.float32)
        scale = as_param(self.scale, x)
        z = (x - as_param(self.loc, x)) / scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)
