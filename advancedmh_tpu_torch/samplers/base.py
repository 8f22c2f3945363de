"""Sampler kernel protocol and transitions (≙ advancedmh_tpu/samplers/base.py).

    sampler.init(gen, model, initial_params) -> (transition, state)
    sampler.step(gen, state, model)          -> (transition, state)

Acceptance uses the reference's ``-randexp() < logα`` (src/mh-core.jl:108).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model
from ..utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Transition:
    """≙ reference ``Transition(params, lp, accepted)`` (src/AdvancedMH.jl:61-65).

    ``lp`` caches the log density so it is never recomputed.
    """

    params: Any
    lp: torch.Tensor
    accepted: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GradientTransition:
    """≙ reference ``GradientTransition`` (src/MALA.jl:14-19): caches the
    log density and its gradient, so a MALA step costs one value-and-gradient
    evaluation."""

    params: Any
    lp: torch.Tensor
    gradient: Any
    accepted: torch.Tensor


def accept_reject(gen: torch.Generator, logalpha) -> torch.Tensor:
    """MH accept test: ``-randexp() < logα`` (≙ src/mh-core.jl:108)."""
    logalpha = torch.as_tensor(logalpha)
    e = torch.empty(logalpha.shape, device=gen.device).exponential_(generator=gen)
    return -e < logalpha


def select_tree(pred: torch.Tensor, on_true, on_false):
    """Elementwise tree select; ``pred`` broadcasts against each leaf from
    the left (one flag per chain)."""

    def sel(t, f):
        mask = pred.reshape(pred.shape + (1,) * (t.ndim - pred.ndim))
        return torch.where(mask, t, f)

    return tree_map(sel, on_true, on_false)


class Sampler:
    """Base class for MH-style samplers (≙ ``MHSampler``, src/AdvancedMH.jl:33)."""

    # True for population samplers (emcee's Ensemble), whose state carries a
    # leading walker axis: it bundles into the 3-D walker array.
    is_population = False

    def init(self, gen, model, initial_params: Optional[Any] = None) -> Tuple[Any, Any]:
        raise NotImplementedError

    def init_batched(
        self, gen, model, batch_shape, initial_params=None, init_batched=False
    ) -> Tuple[Any, Any]:
        """Initial state of a chain batch (≙ the JAX runtime's vmap of init)."""
        raise NotImplementedError

    def step(self, gen, state, model) -> Tuple[Any, Any]:
        raise NotImplementedError

    def step_warmup(self, gen, state, model) -> Tuple[Any, Any]:
        """≙ ``AbstractMCMC.step_warmup``; defaults to ``step``."""
        return self.step(gen, state, model)

    def transition_of(self, state) -> Any:
        return state

    @property
    def has_warmup_phase(self) -> bool:
        return type(self).step_warmup is not Sampler.step_warmup

    def step_warmup_batched(self, gen, state, model, batch_shape):
        return self.step_batched(gen, state, model, batch_shape)  # type: ignore[attr-defined]


def getparams(transition) -> Any:
    """≙ ``AbstractMCMC.getparams``."""
    if hasattr(transition, "params"):
        return transition.params
    if hasattr(transition, "x"):  # RAM state
        return transition.x
    raise TypeError(f"Cannot extract params from {type(transition).__name__}")


def setparams(model, transition, params):
    """≙ ``AbstractMCMC.setparams!!``: a new transition at ``params`` with the
    log density (and a cached gradient) recomputed."""
    from ..models.density import logdensity_and_gradient

    model = as_model(model)
    if isinstance(transition, GradientTransition):
        lp, grad = logdensity_and_gradient(model, params)
        return GradientTransition(params, lp, grad, transition.accepted)
    if isinstance(transition, Transition):
        return Transition(params, model.logdensity_fn(params), transition.accepted)
    if hasattr(transition, "x"):  # RAM state: lp is not recomputed, as in
        # the reference's setparams!! (src/RobustAdaptiveMetropolis.jl:116-121)
        return dataclasses.replace(transition, x=params)
    raise TypeError(f"Cannot set params on {type(transition).__name__}")
