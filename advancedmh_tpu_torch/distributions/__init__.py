from .base import Distribution
from .multivariate import MvNormal
from .univariate import (
    Beta,
    Cauchy,
    Exponential,
    Gamma,
    InverseGamma,
    Laplace,
    LogNormal,
    Normal,
    StudentT,
    TDist,
    Uniform,
)

__all__ = [
    "Beta", "Cauchy", "Distribution", "Exponential", "Gamma", "InverseGamma",
    "Laplace", "LogNormal", "MvNormal", "Normal", "StudentT", "TDist",
    "Uniform",
]
