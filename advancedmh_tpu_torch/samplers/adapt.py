"""Dual-averaging step-size adaptation (≙ advancedmh_tpu/samplers/adapt.py).

Wraps a step-size-indexed family of MH-type samplers and tunes the step
size toward a target acceptance rate during warmup by Nesterov dual
averaging (Hoffman & Gelman 2014 §3.2) on the accept indicator; after warmup
the averaged step size ``exp(log ε̄)`` is frozen. The statistics live in the
state, so under a chain batch each chain adapts its own step size.

    spl = StepSizeAdaptation.rwmh(2, initial_step_size=10.0)
    chains = sample(model, spl, 2000, num_warmup=1000, num_chains=64, ...)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from .base import Sampler

# Finite-dimension optimal RWMH acceptance rates for product-form targets
# (Gelman, Roberts & Gilks 1996, Table 1); 0.234 is the d → ∞ limit.
_GRG_OPTIMAL_ACCEPT = {
    1: 0.441, 2: 0.352, 3: 0.316, 4: 0.285, 5: 0.275,
    6: 0.273, 7: 0.270, 8: 0.267, 9: 0.262, 10: 0.261,
}


def optimal_rwmh_accept(d: int) -> float:
    """Dimension-aware optimal RWMH acceptance target (GRG96 for d ≤ 10,
    the 0.234 asymptote beyond)."""
    return _GRG_OPTIMAL_ACCEPT.get(int(d), 0.234)


@dataclasses.dataclass(frozen=True)
class StepSizeAdaptationState:
    """Inner sampler state + Nesterov dual-averaging statistics."""

    inner: Any  # the wrapped sampler's state
    log_eps: torch.Tensor  # current log step size (warmup iterate)
    log_eps_bar: torch.Tensor  # running average: the frozen post-warmup value
    h_bar: torch.Tensor  # dual-averaging error sum H̄_t
    t: torch.Tensor  # warmup iteration counter (int32, starts at 1)


def dual_average(state, accepted, target: float, t0: float, gamma: float,
                 kappa: float, mu: float):
    """One HG14 update on the accept indicator (elementwise, so the same for
    one chain and for per-chain statistics); returns (log ε, log ε̄, H̄).
    ``t^-κ`` is ``torch.pow``, as the JAX package's XLA path has it."""
    a = torch.as_tensor(accepted).to(torch.float32)
    t = state.t.to(torch.float32)
    w = 1.0 / (t + t0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - a)
    log_eps = mu - torch.sqrt(t) / gamma * h_bar
    eta = torch.pow(t, -kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
    return log_eps, log_eps_bar, h_bar


@dataclasses.dataclass(frozen=True)
class StepSizeAdaptation(Sampler):
    """Tune ``make_sampler(eps)``'s step size to ``target_accept`` in warmup.

    ``make_sampler`` maps a positive step size (a number, or per-chain
    ``(C, 1)`` tensor on a chain batch) to a sampler whose transitions carry
    an ``accepted`` flag."""

    make_sampler: Callable[[Any], Sampler]
    target_accept: float = 0.234
    initial_step_size: float = 1.0
    t0: float = 10.0  # adaptation offset (HG14: stabilises early iterations)
    kappa: float = 0.75  # averaging decay exponent
    gamma: float = 0.05  # shrinkage toward mu
    mu: Optional[float] = None  # shrinkage point; None → log(10·ε₀) (HG14)

    def __post_init__(self):
        if not 0.0 < self.target_accept < 1.0:
            raise ValueError("target_accept must be in (0, 1)")
        if self.initial_step_size <= 0.0:
            raise ValueError("initial_step_size must be positive")
        if self.gamma <= 0.0:
            raise ValueError("gamma must be positive")
        if self.t0 < 0.0:
            raise ValueError("t0 must be non-negative")
        if not 0.0 < self.kappa <= 1.0:
            raise ValueError("kappa must be in (0, 1]")

    # -- helpers -----------------------------------------------------------

    @property
    def _template(self) -> Sampler:
        """A fixed-ε instance for the ε-independent protocol queries."""
        return self.make_sampler(self.initial_step_size)

    @property
    def _mu(self) -> float:
        return math.log(10.0 * self.initial_step_size) if self.mu is None else self.mu

    @property
    def is_population(self) -> bool:  # type: ignore[override]
        return self._template.is_population

    def transition_of(self, state: StepSizeAdaptationState) -> Any:
        return self._template.transition_of(state.inner)

    def _update(self, state, inner_state, accepted) -> StepSizeAdaptationState:
        log_eps, log_eps_bar, h_bar = dual_average(
            state, accepted, self.target_accept, self.t0, self.gamma, self.kappa, self._mu)
        return StepSizeAdaptationState(inner=inner_state, log_eps=log_eps,
                                       log_eps_bar=log_eps_bar, h_bar=h_bar,
                                       t=state.t + 1)

    def _fresh(self, inner_state, batch_shape, device) -> StepSizeAdaptationState:
        log_eps0 = torch.log(torch.full(batch_shape, self.initial_step_size,
                                        dtype=torch.float32, device=device))
        return StepSizeAdaptationState(
            inner=inner_state, log_eps=log_eps0, log_eps_bar=log_eps0.clone(),
            h_bar=torch.zeros(batch_shape, dtype=torch.float32, device=device),
            t=torch.ones(batch_shape, dtype=torch.int32, device=device))

    # -- one chain -----------------------------------------------------------

    def init(self, gen, model, initial_params: Optional[Any] = None):
        t, inner = self._template.init(gen, model, initial_params)
        return t, self._fresh(inner, (), t.lp.device)

    def step_warmup(self, gen, state: StepSizeAdaptationState, model):
        """One inner warmup step at exp(log ε) + one dual-averaging update.
        Delegates to the inner sampler's warmup step, so an inner adaptation
        (RAM's S) keeps running alongside."""
        inner_spl = self.make_sampler(torch.exp(state.log_eps))
        t_out, inner = inner_spl.step_warmup(gen, state.inner, model)
        return t_out, self._update(state, inner, t_out.accepted)

    def step(self, gen, state: StepSizeAdaptationState, model):
        """Post-warmup: the averaged step size is frozen."""
        inner_spl = self.make_sampler(torch.exp(state.log_eps_bar))
        t_out, inner = inner_spl.step(gen, state.inner, model)
        return t_out, dataclasses.replace(state, inner=inner)

    # -- a chain batch -------------------------------------------------------

    @staticmethod
    def _eps_batched(log_eps: torch.Tensor, batch_shape) -> torch.Tensor:
        """Per-chain step sizes shaped ``batch + (1,)``, so the family's
        scalar arithmetic broadcasts over the event axis."""
        return torch.exp(log_eps).reshape(tuple(batch_shape) + (1,))

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...],
                     initial_params=None, init_batched: bool = False):
        t, inner = self._template.init_batched(gen, model, batch_shape,
                                               initial_params, init_batched)
        return t, self._fresh(inner, tuple(batch_shape), t.lp.device)

    def step_batched(self, gen, state: StepSizeAdaptationState, model, batch_shape):
        """Post-warmup batched step at the frozen per-chain exp(log ε̄)."""
        inner_spl = self.make_sampler(self._eps_batched(state.log_eps_bar, batch_shape))
        t_out, inner = inner_spl.step_batched(gen, state.inner, model, batch_shape)
        return t_out, dataclasses.replace(state, inner=inner)

    def step_warmup_batched(self, gen, state: StepSizeAdaptationState, model,
                            batch_shape):
        """Batched warmup: each chain carries and adapts its own statistics."""
        inner_spl = self.make_sampler(self._eps_batched(state.log_eps, batch_shape))
        t_out, inner = inner_spl.step_warmup_batched(gen, state.inner, model, batch_shape)
        return t_out, self._update(state, inner, t_out.accepted)

    # -- convenience families ------------------------------------------------

    @staticmethod
    def rwmh(d: int, target_accept="auto", initial_step_size: float = 1.0,
             device="cuda", **kw) -> "StepSizeAdaptation":
        """Isotropic random-walk family ``RWMH(MvNormal(0, ε·I))`` tuned to
        the dimension-aware optimum (:func:`optimal_rwmh_accept` for
        ``"auto"``). Records ``_fused_family = ("rwmh_iso", d)`` so that
        ``sample(engine="fused")`` runs it on the dual-averaging kernel."""
        from ..distributions import MvNormal
        from .mh import RWMH

        if target_accept == "auto":
            target_accept = optimal_rwmh_accept(d)
        zeros = torch.zeros(int(d), dtype=torch.float32, device=device)
        spl = StepSizeAdaptation(lambda eps: RWMH(MvNormal(zeros, scale=eps)),
                                 target_accept=target_accept,
                                 initial_step_size=initial_step_size, **kw)
        object.__setattr__(spl, "_fused_family", ("rwmh_iso", int(d)))
        return spl

    @staticmethod
    def mala(target_accept: float = 0.574, initial_step_size: float = 0.5,
             **kw) -> "StepSizeAdaptation":
        """Langevin family ``MvNormal(ε²/2·∇, ε·I)`` tuned to the
        Roberts-Rosenthal optimum 0.574."""
        from ..distributions import MvNormal
        from .mala import MALA

        return StepSizeAdaptation(
            lambda eps: MALA(lambda g: MvNormal(0.5 * eps * eps * g, scale=eps)),
            target_accept=target_accept, initial_step_size=initial_step_size, **kw)

    @staticmethod
    def hmc(n_leapfrog: int = 10, target_accept: float = 0.65,
            initial_step_size: float = 0.1, inverse_mass=None,
            **kw) -> "StepSizeAdaptation":
        """Fixed-trajectory HMC family tuned to the Neal/HG14 optimum 0.65."""
        from .hmc import HamiltonianMC

        return StepSizeAdaptation(
            lambda eps: HamiltonianMC(step_size=eps, n_leapfrog=n_leapfrog,
                                      inverse_mass=inverse_mass),
            target_accept=target_accept, initial_step_size=initial_step_size, **kw)

    @staticmethod
    def barker(target_accept: float = 0.57, initial_step_size: float = 0.5,
               **kw) -> "StepSizeAdaptation":
        """Barker-proposal family tuned to the Vogrinc-Livingstone-Zanella
        optimum ≈ 0.57. It runs on the torch engine; the fused engine takes
        only the ``.rwmh`` family."""
        from .barker import Barker

        return StepSizeAdaptation(lambda eps: Barker(step_size=eps),
                                  target_accept=target_accept,
                                  initial_step_size=initial_step_size, **kw)
