"""Log-density model layer (≙ advancedmh_tpu/models/density.py).

A model is a function ``params -> scalar log density`` over a params tree,
plus the device its data lives on. Gradients come from torch autograd
(≙ ``jax.value_and_grad``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch


class CapabilityOrder:
    """≙ LogDensityProblems.LogDensityOrder: 0 = value only, 1 = value+gradient."""

    ZERO = 0
    ONE = 1


@dataclasses.dataclass(frozen=True)
class DensityModel:
    """Wraps a log-density function over a params tree.

    ``logdensity_batched_fn`` is an optional natively batched form
    ``params(C, ...) -> lp(C,)``; by default the batched density is
    ``torch.func.vmap`` of ``logdensity_fn``. ``device`` is where the model's
    data lives and where samplers draw their noise: the card unless the
    caller asks for another (``device="cpu"`` runs on the CPU).
    """

    logdensity_fn: Callable[[Any], torch.Tensor]
    logdensity_and_gradient_fn: Optional[
        Callable[[Any], Tuple[torch.Tensor, Any]]
    ] = None
    dimension: Optional[int] = None
    capabilities: int = CapabilityOrder.ONE
    logdensity_batched_fn: Optional[Callable[[Any], torch.Tensor]] = None
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    def logdensity(self, params) -> torch.Tensor:
        return self.logdensity_fn(params)


def as_model(model_or_fn, device="cuda") -> DensityModel:
    """Coerce a callable or LogDensityProblems-style object to a DensityModel
    (on ``device``, or the object's own ``device`` attribute)."""
    if isinstance(model_or_fn, DensityModel):
        return model_or_fn
    if callable(model_or_fn) and not hasattr(model_or_fn, "logdensity"):
        return DensityModel(logdensity_fn=model_or_fn, device=device)
    ld = getattr(model_or_fn, "logdensity")
    ldg = getattr(model_or_fn, "logdensity_and_gradient", None)
    dim = getattr(model_or_fn, "dimension", None)
    if callable(dim):
        dim = dim()
    cap = getattr(model_or_fn, "capabilities", None)
    if callable(cap):
        cap = cap()
    if cap is None:
        cap = CapabilityOrder.ONE if ldg is not None else CapabilityOrder.ZERO
    return DensityModel(
        logdensity_fn=ld,
        logdensity_and_gradient_fn=ldg,
        dimension=dim,
        capabilities=cap,
        device=getattr(model_or_fn, "device", device),
    )


def logdensity(model: DensityModel, params) -> torch.Tensor:
    """Evaluate the log density (≙ AdvancedMH.logdensity)."""
    return model.logdensity_fn(params)


def logdensity_batched(model: DensityModel, params) -> torch.Tensor:
    """Chain-batched density: leading axis of every params leaf is the chain."""
    if model.logdensity_batched_fn is not None:
        return model.logdensity_batched_fn(params)
    return torch.func.vmap(model.logdensity_fn)(params)


def logdensity_and_gradient(model: DensityModel, params):
    """Value and gradient of the log density, by autograd unless the model
    provides its own."""
    check_capabilities(model)
    if model.logdensity_and_gradient_fn is not None:
        return model.logdensity_and_gradient_fn(params)
    grad, value = torch.func.grad_and_value(model.logdensity_fn)(params)
    return value, grad


def check_capabilities(model: DensityModel) -> None:
    """≙ reference ``check_capabilities`` (src/MALA.jl:42-52)."""
    if model.capabilities is None:
        raise ValueError(
            "The log density model does not declare its capabilities; cannot "
            "verify gradient support."
        )
    if (
        model.capabilities == CapabilityOrder.ZERO
        and model.logdensity_and_gradient_fn is None
    ):
        raise ValueError(
            "The gradient of the log density function is not defined: the model "
            "declares capability order 0 and provides no "
            "logdensity_and_gradient_fn. Provide one, or declare order >= 1 to "
            "use autograd."
        )


def guarded_logdensity(
    support_fn: Callable[[Any], torch.Tensor],
    logdensity_fn: Callable[[Any], torch.Tensor],
    safe_params_fn: Optional[Callable[[Any], Any]] = None,
) -> Callable[[Any], torch.Tensor]:
    """A support-guarded log density whose gradient stays finite.

    The double-where trick: out-of-support params are first replaced by
    ``safe_params_fn(params)``, the density is evaluated there, and the
    result is masked to ``-inf``. A single ``where`` would still evaluate the
    density at the invalid point and give a NaN gradient.
    """

    def guarded(params):
        ok = support_fn(params)
        safe = safe_params_fn(params) if safe_params_fn is not None else params
        lp = logdensity_fn(safe)
        return torch.where(ok, lp, torch.full_like(lp, -torch.inf))

    return guarded
