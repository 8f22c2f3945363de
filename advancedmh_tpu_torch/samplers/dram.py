"""DRAM: delayed rejection with adaptive Metropolis (≙
advancedmh_tpu/samplers/dram.py; Haario, Laine, Mira & Saksman 2006).

Both stages of :class:`DelayedRejection` propose from the chain's running
covariance of :class:`AdaptiveMetropolis`, the second shrunk by ``gamma``:

    stage 1:  y₁ = x + (s/√d)·L z₁          s = opt_scale (2.38)
    stage 2:  y₂ = x + γ(s/√d)·L z₂          γ = gamma (0.2)

with Mira's stage-2 acceptance. The two stages share L, so the q₁ cross
term lives in z-space and needs no triangular solve:

    log q₁(y₁|y₂) − log q₁(y₁|x) = −½(‖z₁ − γz₂‖² − ‖z₁‖²).

The state, its start and the Welford advance (every step, diminishing as
1/n) are AdaptiveMetropolis's, with β = 0. A step is its draws (z₁, z₂ and
two Exp(1)) then :meth:`DRAM.dram_move`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, logdensity, logdensity_batched
from ..ops.dr import log1m_exp as _log1m_exp
from .am import AdaptiveMetropolis, AdaptiveMetropolisState
from .base import Sampler, Transition
from .ram import _bmv


@dataclasses.dataclass(frozen=True)
class DRAM(Sampler):
    """``DRAM(opt_scale=2.38, gamma=0.2, fixed_scale=0.1)``: ``opt_scale`` is
    the stage-1 multiplier (as ``opt_scale/√d`` on L), ``gamma`` the stage-2
    shrink, ``fixed_scale`` the C₀ seed's scale (≙ AdaptiveMetropolis);
    ``pooled`` shares one covariance across the chains of a batch."""

    opt_scale: float = 2.38
    gamma: float = 0.2
    fixed_scale: float = 0.1
    pooled: bool = False

    def __post_init__(self):
        if not 0.0 < self.gamma < 1.0:
            raise ValueError(
                f"gamma must be in (0, 1) — a *timid* second stage; got {self.gamma}"
            )

    def _am(self) -> AdaptiveMetropolis:
        """AdaptiveMetropolis's state, start and adaptation, reused."""
        return AdaptiveMetropolis(beta=0.0, fixed_scale=self.fixed_scale,
                                  opt_scale=self.opt_scale, pooled=self.pooled)

    def transition_of(self, state: AdaptiveMetropolisState) -> Transition:
        return Transition(state.x, state.logprob, state.isaccept)

    def init(self, gen, model, initial_params: Optional[Any] = None):
        return self._am().init(gen, model, initial_params)

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
        return self._am().init_batched(gen, model, batch_shape, initial_params, init_batched)

    def draws(self, gen, x, batch_shape):
        """The step's random numbers: z₁, z₂ (x's shape) and the two accept
        tests' Exp(1)."""
        dev = gen.device
        z1, z2 = (torch.randn(tuple(x.shape), generator=gen, device=dev) for _ in range(2))
        e1, e2 = (torch.empty(tuple(batch_shape), device=dev).exponential_(generator=gen)
                  for _ in range(2))
        return z1, z2, e1, e2

    def dram_move(self, model, state: AdaptiveMetropolisState, z1, z2, e1, e2,
                  batch_shape=()) -> AdaptiveMetropolisState:
        """The deterministic move from ``state`` given z₁, z₂ and the two
        Exp(1): both stages, Mira's stage-2 ratio with the z-space q₁ term,
        then the moments advance with the realized state."""
        model = as_model(model)
        batched = len(batch_shape) > 0
        lp_fn = (lambda p: logdensity_batched(model, p)) if batched else (
            lambda p: logdensity(model, p))
        x, lp0 = state.x, state.logprob
        s = self.opt_scale / math.sqrt(x.shape[-1])
        g = self.gamma
        y1 = x + s * _bmv(state.L, z1)
        lp1 = lp_fn(y1)
        la1 = lp1 - lp0
        acc1 = -e1 < la1
        y2 = x + (g * s) * _bmv(state.L, z2)
        lp2 = lp_fn(y2)
        dz = z1 - g * z2
        dq = -0.5 * (torch.sum(dz * dz, dim=-1) - torch.sum(z1 * z1, dim=-1))
        la2 = lp2 - lp0 + dq + _log1m_exp(lp1 - lp2) - _log1m_exp(la1)
        acc2 = (-e2 < la2) & ~acc1
        x_new = torch.where(acc1[..., None], y1, torch.where(acc2[..., None], y2, x))
        lp_new = torch.where(acc1, lp1, torch.where(acc2, lp2, lp0))
        mean_new, L_new, it_new = self._am()._advance_moments(state, x_new, batched)
        return AdaptiveMetropolisState(x=x_new, logprob=lp_new, mean=mean_new, L=L_new,
                                       iteration=it_new, isaccept=acc1 | acc2)

    def step_batched(self, gen, state, model, batch_shape: Tuple[int, ...]):
        z1, z2, e1, e2 = self.draws(gen, state.x, batch_shape)
        new = self.dram_move(model, state, z1, z2, e1, e2, tuple(batch_shape))
        return self.transition_of(new), new

    def step(self, gen, state, model):
        return self.step_batched(gen, state, model, ())
