"""Multivariate normal (≙ advancedmh_tpu/distributions/multivariate.py).

Exactly one scale form is active: ``scale_tril`` (lower Cholesky factor of
the covariance), ``scale_diag`` (per-dimension std-devs) or ``scale`` (an
isotropic std-dev, 1.0 by default). The diagonal and isotropic forms never
form a matrix product.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .base import Distribution, as_param
from .univariate import _LOG_2PI


@dataclasses.dataclass(frozen=True)
class MvNormal(Distribution):
    loc: torch.Tensor
    scale_tril: Optional[torch.Tensor] = None
    scale_diag: Optional[torch.Tensor] = None
    scale: object = 1.0

    @staticmethod
    def from_cov(loc: torch.Tensor, cov: torch.Tensor) -> "MvNormal":
        return MvNormal(loc=loc, scale_tril=torch.linalg.cholesky(cov))

    @staticmethod
    def standard(d: int, device="cuda") -> "MvNormal":
        return MvNormal(loc=torch.zeros(d, dtype=torch.float32, device=device))

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.dim,)

    def sample(self, gen, sample_shape: Tuple[int, ...] = ()):
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=gen, device=gen.device)
        if self.scale_tril is not None:
            return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril, eps)
        if self.scale_diag is not None:
            return self.loc + self.scale_diag * eps
        return self.loc + as_param(self.scale, eps) * eps

    def log_prob(self, x):
        d = self.dim
        diff = x - self.loc
        if self.scale_tril is not None:
            L = self.scale_tril
            batch = torch.broadcast_shapes(L.shape[:-2], diff.shape[:-1])
            L = L.expand(batch + L.shape[-2:])
            diff = diff.expand(batch + (d,))
            z = torch.linalg.solve_triangular(L, diff[..., None], upper=False)[
                ..., 0
            ]
            half_logdet = torch.sum(
                torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1
            )
        elif self.scale_diag is not None:
            z = diff / self.scale_diag
            half_logdet = torch.sum(torch.log(self.scale_diag), dim=-1)
        else:
            s = as_param(self.scale, diff)
            z = diff / s
            if s.ndim > 0 and s.shape[-1] == 1:
                # a batch of per-chain scalar scales carries a trailing
                # singleton for sample(); log_prob stays (batch,)-shaped
                s = s[..., 0]
            half_logdet = d * torch.log(s)
        maha = torch.sum(z * z, dim=-1)
        return -0.5 * (maha + d * _LOG_2PI) - half_logdet
