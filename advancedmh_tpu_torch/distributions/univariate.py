"""Univariate distributions (≙ advancedmh_tpu/distributions/univariate.py).

Log-densities are written out in torch operations with the JAX package's
formulas (so they broadcast over batch shapes and run under ``vmap``);
``sample`` draws with an explicit ``torch.Generator`` on its device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .base import Distribution, as_param

_LOG_2PI = math.log(2.0 * math.pi)


def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else ()


def _bshape(*params) -> Tuple[int, ...]:
    """Broadcast shape of distribution parameters (batch shape)."""
    return tuple(torch.broadcast_shapes(*(_shape(p) for p in params)))


def _draw_shape(sample_shape, *params) -> Tuple[int, ...]:
    return tuple(sample_shape) + _bshape(*params)


def _as_x(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _uniform(gen, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _normal(gen, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device)


def _gamma(gen, concentration, shape) -> torch.Tensor:
    """Gamma(concentration, 1) draws of ``shape``."""
    alpha = as_param(concentration, torch.empty((), device=gen.device))
    alpha = alpha.to(gen.device, torch.float32).expand(shape).contiguous()
    return torch._standard_gamma(alpha, generator=gen)


def _neg_inf_unless(ok, lp):
    return torch.where(ok, lp, torch.full_like(lp, -torch.inf))


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def sample(self, gen, sample_shape: Tuple[int, ...] = ()):
        eps = _normal(gen, _draw_shape(sample_shape, self.loc, self.scale))
        return as_param(self.loc, eps) + as_param(self.scale, eps) * eps

    def log_prob(self, x):
        x = _as_x(x)
        scale = as_param(self.scale, x)
        z = (x - as_param(self.loc, x)) / scale
        return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def sample(self, gen, sample_shape=()):
        eps = _normal(gen, _draw_shape(sample_shape, self.loc, self.scale))
        return torch.exp(as_param(self.loc, eps) + as_param(self.scale, eps) * eps)

    def log_prob(self, x):
        x = _as_x(x)
        scale = as_param(self.scale, x)
        logx = torch.log(x)
        z = (logx - as_param(self.loc, x)) / scale
        return _neg_inf_unless(x > 0, -0.5 * (z * z + _LOG_2PI) - torch.log(scale) - logx)


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    low: object = 0.0
    high: object = 1.0

    def sample(self, gen, sample_shape=()):
        u = _uniform(gen, _draw_shape(sample_shape, self.low, self.high))
        low = as_param(self.low, u)
        return low + (as_param(self.high, u) - low) * u

    def log_prob(self, x):
        x = _as_x(x)
        low, high = as_param(self.low, x), as_param(self.high, x)
        inside = (x >= low) & (x <= high)
        return _neg_inf_unless(inside, -torch.log(high - low) + torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    rate: object = 1.0

    def sample(self, gen, sample_shape=()):
        shape = _draw_shape(sample_shape, self.rate)
        e = torch.empty(shape, device=gen.device).exponential_(generator=gen)
        return e / as_param(self.rate, e)

    def log_prob(self, x):
        x = _as_x(x)
        rate = as_param(self.rate, x)
        return _neg_inf_unless(x >= 0, torch.log(rate) - rate * x)


@dataclasses.dataclass(frozen=True)
class Laplace(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def sample(self, gen, sample_shape=()):
        u = _uniform(gen, _draw_shape(sample_shape, self.loc, self.scale)) - 0.5
        lap = -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
        return as_param(self.loc, u) + as_param(self.scale, u) * lap

    def log_prob(self, x):
        x = _as_x(x)
        scale = as_param(self.scale, x)
        return -torch.abs(x - as_param(self.loc, x)) / scale - torch.log(2.0 * scale)


@dataclasses.dataclass(frozen=True)
class Cauchy(Distribution):
    loc: object = 0.0
    scale: object = 1.0

    def sample(self, gen, sample_shape=()):
        u = _uniform(gen, _draw_shape(sample_shape, self.loc, self.scale))
        return as_param(self.loc, u) + as_param(self.scale, u) * torch.tan(math.pi * (u - 0.5))

    def log_prob(self, x):
        x = _as_x(x)
        scale = as_param(self.scale, x)
        z = (x - as_param(self.loc, x)) / scale
        return -torch.log1p(z * z) - torch.log(math.pi * scale)


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    """Student's t (≙ Distributions.jl ``TDist`` when loc = 0, scale = 1)."""

    df: object = 1.0
    loc: object = 0.0
    scale: object = 1.0

    def sample(self, gen, sample_shape=()):
        shape = _draw_shape(sample_shape, self.df, self.loc, self.scale)
        eps = _normal(gen, shape)
        df = as_param(self.df, eps)
        chi2 = 2.0 * _gamma(gen, 0.5 * df, shape)
        t = eps * torch.rsqrt(chi2 / df)
        return as_param(self.loc, eps) + as_param(self.scale, eps) * t

    def log_prob(self, x):
        x = _as_x(x)
        df, scale = as_param(self.df, x), as_param(self.scale, x)
        z = (x - as_param(self.loc, x)) / scale
        lognorm = (torch.lgamma(0.5 * (df + 1.0)) - torch.lgamma(0.5 * df)
                   - 0.5 * torch.log(df * math.pi) - torch.log(scale))
        return lognorm - 0.5 * (df + 1.0) * torch.log1p(z * z / df)


def TDist(df) -> StudentT:
    """The reference's ``TDist(ν)``: the standard Student's t."""
    return StudentT(df=df)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    """Gamma(shape = concentration, rate)."""

    concentration: object = 1.0
    rate: object = 1.0

    def sample(self, gen, sample_shape=()):
        shape = _draw_shape(sample_shape, self.concentration, self.rate)
        g = _gamma(gen, self.concentration, shape)
        return g / as_param(self.rate, g)

    def log_prob(self, x):
        x = _as_x(x)
        a, b = as_param(self.concentration, x), as_param(self.rate, x)
        lp = a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x) - b * x
        return _neg_inf_unless(x > 0, lp)


@dataclasses.dataclass(frozen=True)
class InverseGamma(Distribution):
    """InverseGamma(shape, scale), as Distributions.jl's ``InverseGamma(α, θ)``."""

    concentration: object = 1.0
    scale: object = 1.0

    def sample(self, gen, sample_shape=()):
        shape = _draw_shape(sample_shape, self.concentration, self.scale)
        g = _gamma(gen, self.concentration, shape)
        return as_param(self.scale, g) / g

    def log_prob(self, x):
        x = _as_x(x)
        a, s = as_param(self.concentration, x), as_param(self.scale, x)
        lp = a * torch.log(s) - torch.lgamma(a) - (a + 1.0) * torch.log(x) - s / x
        return _neg_inf_unless(x > 0, lp)


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    a: object = 1.0
    b: object = 1.0

    def sample(self, gen, sample_shape=()):
        shape = _draw_shape(sample_shape, self.a, self.b)
        ga = _gamma(gen, self.a, shape)
        return ga / (ga + _gamma(gen, self.b, shape))

    def log_prob(self, x):
        x = _as_x(x)
        a, b = as_param(self.a, x), as_param(self.b, x)
        betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        lp = (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - betaln
        return _neg_inf_unless((x > 0) & (x < 1), lp)
