"""Carry the JAX package's state across, as numpy arrays.

Functions here take numpy arrays (never JAX objects) and return the port's
objects on a given device (the card unless the caller asks for another),
so one set of inputs can be handed to both packages: model data (the GP
latent field's with its prior), proposal scales, and the states of RWMH, MALA, RAM, the ensemble sampler,
StepSizeAdaptation, AdaptiveHMC, ChEES-HMC, MEADS and Adaptive Metropolis
(DRAM's too) and replica exchange for ``initial_params`` /
``initial_state``. The states of delayed rejection, Multiple-Try Metropolis
and DE-MC are Transitions (:func:`transition_from_numpy`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .distributions import MvNormal
from .models.targets import (TileDensityModel, _gp_model, correlated_gaussian_model,
                             emcee_demo_model, gaussian_mean_scale_model,
                             logistic_regression_model)
from .samplers.adapt import StepSizeAdaptationState
from .samplers.am import AdaptiveMetropolisState
from .samplers.base import GradientTransition, Transition
from .samplers.chees import ChEESHMCState
from .samplers.hmc_adapt import AdaptiveHMCState
from .samplers.meads import MEADSState
from .samplers.ram import RobustAdaptiveMetropolisState
from .samplers.tempering import ReplicaExchangeState


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _bool(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, bool), device=device)


def gaussian_mean_scale_from_numpy(data: np.ndarray, device="cuda") -> TileDensityModel:
    """The (μ, σ) flagship model on the observations ``data``."""
    return gaussian_mean_scale_model(data=np.asarray(data, np.float32), device=device)


def correlated_gaussian_from_numpy(cov: np.ndarray, device="cuda") -> TileDensityModel:
    """The zero-mean Gaussian target with covariance ``cov``."""
    return correlated_gaussian_model(np.asarray(cov, np.float64), device=device)


def emcee_demo_from_numpy(transformed: bool = False, device="cuda") -> TileDensityModel:
    """The emcee test model (it has no data: both packages build it alike)."""
    return emcee_demo_model(transformed=transformed, device=device)


def logistic_regression_from_numpy(X: np.ndarray, y: np.ndarray,
                                   prior_scale: float = 10.0,
                                   device="cuda") -> TileDensityModel:
    """The logistic regression on the data ``X`` (n, d) and ``y`` (n,)."""
    return logistic_regression_model(X=np.asarray(X, np.float32),
                                     y=np.asarray(y, np.float32),
                                     prior_scale=prior_scale, device=device)


def gp_latent_from_numpy(y: np.ndarray, L: np.ndarray, likelihood: str = "gaussian",
                         noise: float = 0.25, device="cuda"):
    """The GP latent field's likelihood model on the observations ``y`` and
    its prior ``MvNormal(0, scale_tril=L)``, from the JAX package's arrays
    (``aux["y"]`` and ``prior.scale_tril`` of its ``gp_latent_model``)."""
    if likelihood not in ("gaussian", "logistic"):
        raise ValueError(f"unknown likelihood {likelihood!r}")
    L = _f32(L, device)
    return (_gp_model(np.asarray(y, np.float64), likelihood, float(noise), device),
            MvNormal(torch.zeros(L.shape[0], dtype=torch.float32, device=device), scale_tril=L))


def mvnormal_from_numpy(
    loc: np.ndarray,
    scale: Optional[float] = None,
    scale_diag: Optional[np.ndarray] = None,
    scale_tril: Optional[np.ndarray] = None,
    device="cuda",
) -> MvNormal:
    """An MvNormal with one of the three scale forms."""
    kw = {}
    if scale_tril is not None:
        kw["scale_tril"] = _f32(scale_tril, device)
    elif scale_diag is not None:
        kw["scale_diag"] = _f32(scale_diag, device)
    elif scale is not None:
        kw["scale"] = float(scale)
    return MvNormal(loc=_f32(loc, device), **kw)


def transition_from_numpy(
    params: np.ndarray, lp: np.ndarray, accepted: np.ndarray, device="cuda"
) -> Transition:
    """A Transition from its three arrays: one chain, a chain batch, or an
    ensemble's walkers ``(W, d)`` / ``(W,)``."""
    return Transition(_f32(params, device), _f32(lp, device), _bool(accepted, device))


def gradient_transition_from_numpy(
    params: np.ndarray, lp: np.ndarray, gradient: np.ndarray,
    accepted: np.ndarray, device="cuda",
) -> GradientTransition:
    """A MALA state (params, lp, gradient, accepted)."""
    return GradientTransition(_f32(params, device), _f32(lp, device),
                              _f32(gradient, device), _bool(accepted, device))


def ram_state_from_numpy(
    x: np.ndarray, logprob: np.ndarray, S: np.ndarray, logalpha: np.ndarray,
    eta: np.ndarray, iteration: np.ndarray, isaccept: np.ndarray, device="cuda",
) -> RobustAdaptiveMetropolisState:
    """A RAM state; ``S`` is ``(C, d, d)`` (or ``(d, d)`` for one chain) at
    the API, as the JAX state holds it (the kernel takes ``(d*d, C)``)."""
    return RobustAdaptiveMetropolisState(
        x=_f32(x, device), logprob=_f32(logprob, device), S=_f32(S, device),
        logalpha=_f32(logalpha, device), eta=_f32(eta, device),
        iteration=torch.as_tensor(np.asarray(iteration, np.int32), device=device),
        isaccept=_bool(isaccept, device),
    )


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def step_size_adaptation_state_from_numpy(
    inner, log_eps: np.ndarray, log_eps_bar: np.ndarray, h_bar: np.ndarray,
    t: np.ndarray, device="cuda",
) -> StepSizeAdaptationState:
    """A StepSizeAdaptation state around ``inner``, the wrapped sampler's
    state already carried across (e.g. :func:`transition_from_numpy`)."""
    return StepSizeAdaptationState(inner=inner, log_eps=_f32(log_eps, device),
                                   log_eps_bar=_f32(log_eps_bar, device),
                                   h_bar=_f32(h_bar, device), t=_i32(t, device))


def adaptive_hmc_state_from_numpy(
    inner: GradientTransition, log_eps: np.ndarray, log_eps_bar: np.ndarray,
    h_bar: np.ndarray, t: np.ndarray, mean: np.ndarray, m2: np.ndarray,
    n: np.ndarray, inverse_mass: np.ndarray, device="cuda",
) -> AdaptiveHMCState:
    """An AdaptiveHMC state (vector params): ``inner`` from
    :func:`gradient_transition_from_numpy`, the rest as the JAX state holds
    them (per chain on a leading axis)."""
    return AdaptiveHMCState(
        inner=inner, log_eps=_f32(log_eps, device), log_eps_bar=_f32(log_eps_bar, device),
        h_bar=_f32(h_bar, device), t=_i32(t, device), mean=_f32(mean, device),
        m2=_f32(m2, device), n=_f32(n, device), inverse_mass=_f32(inverse_mass, device),
    )


def chees_state_from_numpy(
    inner: GradientTransition, log_eps: np.ndarray, log_eps_bar: np.ndarray,
    h_bar: np.ndarray, log_traj: np.ndarray, log_traj_bar: np.ndarray,
    adam_m: np.ndarray, adam_v: np.ndarray, t: np.ndarray, mean: np.ndarray,
    m2: np.ndarray, n: np.ndarray, inverse_mass: np.ndarray, device="cuda",
) -> ChEESHMCState:
    """A ChEES-HMC state (vector params): ``inner`` from
    :func:`gradient_transition_from_numpy`, the statistics as the JAX state
    holds them (replicated over the chains on a leading axis)."""
    f = lambda a: _f32(a, device)
    return ChEESHMCState(
        inner=inner, log_eps=f(log_eps), log_eps_bar=f(log_eps_bar), h_bar=f(h_bar),
        log_traj=f(log_traj), log_traj_bar=f(log_traj_bar), adam_m=f(adam_m),
        adam_v=f(adam_v), t=_i32(t, device), mean=f(mean), m2=f(m2), n=f(n),
        inverse_mass=f(inverse_mass),
    )


def meads_state_from_numpy(
    x: np.ndarray, lp: np.ndarray, grad: np.ndarray, p: np.ndarray, u: np.ndarray,
    iteration: np.ndarray, isaccept: np.ndarray, device="cuda",
) -> MEADSState:
    """A MEADS state: per chain x, gradient and the persistent momentum
    ``(C, d)``, lp, the slice variable u, iteration and isaccept ``(C,)``."""
    f = lambda a: _f32(a, device)
    return MEADSState(x=f(x), lp=f(lp), grad=f(grad), p=f(p), u=f(u),
                      iteration=_i32(iteration, device), isaccept=_bool(isaccept, device))


def am_state_from_numpy(
    x: np.ndarray, logprob: np.ndarray, mean: np.ndarray, L: np.ndarray,
    iteration: np.ndarray, isaccept: np.ndarray, device="cuda",
) -> AdaptiveMetropolisState:
    """An Adaptive Metropolis (or DRAM) state: x and mean ``(C, d)``, the
    lower factor L ``(C, d, d)``, logprob, iteration and isaccept ``(C,)``
    (or one chain without the leading axis), as the JAX state holds them."""
    f = lambda a: _f32(a, device)
    return AdaptiveMetropolisState(x=f(x), logprob=f(logprob), mean=f(mean), L=f(L),
                                   iteration=_i32(iteration, device),
                                   isaccept=_bool(isaccept, device))


def replica_exchange_state_from_numpy(inner, swap_accept_count: np.ndarray,
                                      swap_proposal_count: np.ndarray,
                                      device="cuda") -> ReplicaExchangeState:
    """A replica-exchange state around ``inner``, the stacked inner states
    already carried across (e.g. :func:`transition_from_numpy` of leaves
    ``(C, K, ...)``, lp the tempered β·ℓ), and the swap counts ``(C, K−1)``
    (or ``(K−1,)`` for one chain), as the JAX state holds them."""
    return ReplicaExchangeState(inner=inner, swap_accept_count=_f32(swap_accept_count, device),
                                swap_proposal_count=_f32(swap_proposal_count, device))
