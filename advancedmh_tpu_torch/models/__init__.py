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
    correlated_gaussian_model,
    correlated_gaussian_tile,
    correlated_gaussian_tile_value_and_grad,
    emcee_demo_model,
    emcee_demo_tile,
    gaussian_mean_scale_model,
    gaussian_mean_scale_tile,
    gaussian_mean_scale_tile_value_and_grad,
    logistic_regression_model,
    logistic_regression_tile,
    logistic_regression_tile_value_and_grad,
    neal_funnel_model,
    neal_funnel_tile,
    neal_funnel_tile_value_and_grad,
)

__all__ = [
    "CapabilityOrder", "DensityModel", "as_model", "check_capabilities",
    "guarded_logdensity", "logdensity", "logdensity_and_gradient",
    "logdensity_batched", "TileDensityModel", "correlated_gaussian_model",
    "correlated_gaussian_tile", "correlated_gaussian_tile_value_and_grad",
    "emcee_demo_model", "emcee_demo_tile", "gaussian_mean_scale_model",
    "gaussian_mean_scale_tile", "gaussian_mean_scale_tile_value_and_grad",
    "logistic_regression_model", "logistic_regression_tile",
    "logistic_regression_tile_value_and_grad", "neal_funnel_model",
    "neal_funnel_tile", "neal_funnel_tile_value_and_grad",
]
