from .density import (
    CapabilityOrder,
    DensityModel,
    as_model,
    check_capabilities,
    guarded_logdensity,
    logdensity,
    logdensity_and_gradient,
    logdensity_batched,
)
from .targets import (
    TileDensityModel,
    gaussian_mean_scale_model,
    gaussian_mean_scale_tile,
)

__all__ = [
    "CapabilityOrder", "DensityModel", "as_model", "check_capabilities",
    "guarded_logdensity", "logdensity", "logdensity_and_gradient",
    "logdensity_batched", "TileDensityModel", "gaussian_mean_scale_model",
    "gaussian_mean_scale_tile",
]
