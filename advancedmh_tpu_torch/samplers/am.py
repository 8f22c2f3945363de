"""Adaptive Metropolis (≙ advancedmh_tpu/samplers/am.py; Haario, Saksman &
Tamminen 2001, in Roberts & Rosenthal's 2009 mixture form).

Proposal at iteration n:

    Q_n(x, ·) = (1 − β)·N(x, (2.38²/d)·Σ_n) + β·N(x, (0.1²/d)·I),

with Σ_n the chain's running empirical covariance and only the fixed
component for the first ``adapt_start`` iterations (2d by default). Σ_n is
carried as its Cholesky factor L and advanced exactly by the Welford
rank-1 update (always an update, never a downdate):

    L_n = rank1_update(√((n−1)/n)·L_{n−1}, (√(n−1)/n)·δ),  δ = x_n − μ_{n−1}.

Adaptation uses every chain state, accepted or not, and never freezes: the
1/n weights make it diminish. ``pooled=True`` merges all chains of a batch
into one shared (mean, Σ) each step (Chan, Golub & LeVeque's batch update
and a d × d refactorization).

A step is its draws (:meth:`AdaptiveMetropolis.draws`) then a deterministic
move (:meth:`AdaptiveMetropolis.am_move`), so that a test can drive the
move with the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, logdensity, logdensity_batched
from ..ops.cholesky import chol_rank1_update_batched
from .base import Sampler, Transition
from .ram import _bmv


@dataclasses.dataclass(frozen=True)
class AdaptiveMetropolisState:
    """Chain state and the running moments of the chain history."""

    x: torch.Tensor  # current realization
    logprob: torch.Tensor  # log density of x
    mean: torch.Tensor  # running mean of the chain history
    L: torch.Tensor  # lower Cholesky factor of the running covariance
    iteration: torch.Tensor  # chain states consumed (int32, >= 1)
    isaccept: torch.Tensor  # whether the previous step was accepted


def _outer_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_c a_c b_cᵀ over the rows of a, b (C, d), as float32 multiplies and
    adds (no matmul unit, so no TF32: the JAX package asks for
    ``Precision.HIGHEST`` here)."""
    return (a[:, :, None] * b[:, None, :]).sum(0)


@dataclasses.dataclass(frozen=True)
class AdaptiveMetropolis(Sampler):
    """``AdaptiveMetropolis()`` with Roberts & Rosenthal's defaults.

    ``beta`` is the fixed component's weight, ``fixed_scale`` its std-dev
    multiplier (as ``fixed_scale/√d``), ``opt_scale`` the adapted
    component's (as ``opt_scale/√d`` on L), ``adapt_start`` the iteration
    after which the adapted component may be chosen (None → 2d); ``pooled``
    shares one covariance across the chains of a batch."""

    beta: float = 0.05
    fixed_scale: float = 0.1
    opt_scale: float = 2.38
    adapt_start: Optional[int] = None
    pooled: bool = False

    def _dim(self, model, initial_params) -> int:
        if initial_params is not None:
            return int(initial_params.shape[-1])
        if model.dimension is not None:
            return int(model.dimension)
        raise ValueError(
            "AdaptiveMetropolis needs the model dimension: pass "
            "initial_params or set DensityModel(dimension=...)."
        )

    def _adapt_start(self, d: int) -> int:
        return 2 * d if self.adapt_start is None else int(self.adapt_start)

    def transition_of(self, state: AdaptiveMetropolisState) -> Transition:
        return Transition(state.x, state.logprob, state.isaccept)

    # -- init ------------------------------------------------------------------

    def _state(self, x, lp, batch_shape):
        """A fresh state at x: mean x, L = (fixed_scale/√d)·I (Haario's C₀
        as one pseudo-observation), iteration 1."""
        d = x.shape[-1]
        L0 = (self.fixed_scale / math.sqrt(d)) * torch.eye(d, dtype=x.dtype, device=x.device)
        return AdaptiveMetropolisState(
            x=x, logprob=lp, mean=x.clone(), L=L0.expand(batch_shape + (d, d)).clone(),
            iteration=torch.ones(batch_shape, dtype=torch.int32, device=x.device),
            isaccept=torch.ones(batch_shape, dtype=torch.bool, device=x.device),
        )

    def init(self, gen, model, initial_params: Optional[Any] = None):
        model = as_model(model)
        d = self._dim(model, initial_params)
        if initial_params is None:
            x = torch.randn((d,), generator=gen, device=gen.device)
        else:
            x = torch.as_tensor(initial_params, dtype=torch.float32)
        state = self._state(x, logdensity(model, x), ())
        return self.transition_of(state), state

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
        model = as_model(model)
        d = self._dim(model, initial_params)
        if initial_params is None:
            x = torch.randn(batch_shape + (d,), generator=gen, device=gen.device)
        elif init_batched:
            x = initial_params
        else:
            x = initial_params.expand(batch_shape + (d,)).clone()
        state = self._state(x, logdensity_batched(model, x), tuple(batch_shape))
        return self.transition_of(state), state

    # -- the moments -------------------------------------------------------------

    def _moments_update(self, state, x_new):
        """(mean, L) after consuming ``x_new``, per chain (Welford, exact;
        JAX's XLA order: √(n/(n+1)) and √n/(n+1))."""
        n = state.iteration.to(state.L.dtype)  # count before x_new
        delta = x_new - state.mean
        n1 = n + 1.0
        mean_new = state.mean + delta * (torch.ones_like(n1) / n1)[..., None]
        shrink = torch.sqrt(n / n1)
        v = (torch.sqrt(n) / n1)[..., None] * delta
        L_new, _ = chol_rank1_update_batched(shrink[..., None, None] * state.L, v, 1.0)
        return mean_new, L_new

    def _moments_update_pooled(self, state, x_new):
        """Cross-chain pooled Welford merge: the C new states enter one
        shared (mean, Σ) by the exact batch formula

            M2' = M2 + Σ_c (x_c − x̄)(x_c − x̄)ᵀ + (nC/(n+C))·δδᵀ,  δ = x̄ − mean,

        then L = chol(M2'/(n+C)). Chain 0's moments seed the pool; the
        result is replicated over the chains."""
        d = x_new.shape[-1]
        flat = x_new.reshape(-1, d)
        C = flat.shape[0]
        n = state.iteration.reshape(-1)[0].to(state.L.dtype)
        mean0 = state.mean.reshape(-1, d)[0]
        L0 = state.L.reshape(-1, d, d)[0]
        b_mean = torch.mean(flat, dim=0)
        centered = flat - b_mean
        delta = b_mean - mean0
        n_new = n + C
        mean_new = mean0 + (torch.full_like(n_new, C) / n_new) * delta
        M2 = n * _outer_sum(L0.T, L0.T)  # n·L₀L₀ᵀ
        M2_new = M2 + _outer_sum(centered, centered) + (n * C / n_new) * (delta[:, None] * delta)
        L_new = torch.linalg.cholesky(M2_new / n_new)
        return (mean_new.expand(x_new.shape).clone(),
                L_new.expand(x_new.shape[:-1] + (d, d)).clone())

    def _advance_moments(self, state, x_new, batched: bool):
        """(mean, L, iteration) after consuming ``x_new``, pooled or per chain."""
        if batched and self.pooled:
            mean_new, L_new = self._moments_update_pooled(state, x_new)
            return mean_new, L_new, state.iteration + math.prod(x_new.shape[:-1])
        mean_new, L_new = self._moments_update(state, x_new)
        return mean_new, L_new, state.iteration + 1

    # -- one step ------------------------------------------------------------------

    def draws(self, gen, x, batch_shape):
        """The step's random numbers: the increment's normals (x's shape),
        the mixture uniform and the accept's Exp(1)."""
        dev = gen.device
        z = torch.randn(tuple(x.shape), generator=gen, device=dev)
        u_mix = torch.rand(tuple(batch_shape), generator=gen, device=dev)
        e = torch.empty(tuple(batch_shape), device=dev).exponential_(generator=gen)
        return z, u_mix, e

    def am_move(self, model, state: AdaptiveMetropolisState, z, u_mix, e_acc,
                batch_shape=()):
        """The deterministic move from ``state`` given the normals ``z``, the
        mixture uniform ``u_mix`` and the accept's Exp(1) ``e_acc``: the
        symmetric mixture increment, accept iff −e < lp' − lp, then the
        moments advance with the realized state. Returns the new state."""
        model = as_model(model)
        batched = len(batch_shape) > 0
        x = state.x
        d = x.shape[-1]
        fixed = (self.fixed_scale / math.sqrt(d)) * z
        adapted = (self.opt_scale / math.sqrt(d)) * _bmv(state.L, z)
        use_fixed = (u_mix < self.beta) | (state.iteration <= self._adapt_start(d))
        x_cand = x + torch.where(use_fixed[..., None], fixed, adapted)
        lp_cand = (logdensity_batched if batched else logdensity)(model, x_cand)
        isaccept = -e_acc < lp_cand - state.logprob  # the mixture is symmetric
        x_new = torch.where(isaccept[..., None], x_cand, x)
        lp_new = torch.where(isaccept, lp_cand, state.logprob)
        mean_new, L_new, it_new = self._advance_moments(state, x_new, batched)
        return AdaptiveMetropolisState(x=x_new, logprob=lp_new, mean=mean_new, L=L_new,
                                       iteration=it_new, isaccept=isaccept)

    def step_batched(self, gen, state, model, batch_shape: Tuple[int, ...]):
        z, u_mix, e = self.draws(gen, state.x, batch_shape)
        new = self.am_move(model, state, z, u_mix, e, tuple(batch_shape))
        return self.transition_of(new), new

    def step(self, gen, state, model):
        return self.step_batched(gen, state, model, ())
