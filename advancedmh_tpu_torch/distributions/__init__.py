from .base import Distribution
from .multivariate import MvNormal
from .univariate import Normal

__all__ = ["Distribution", "MvNormal", "Normal"]
