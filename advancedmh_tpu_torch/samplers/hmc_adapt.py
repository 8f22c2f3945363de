"""Adaptive HMC: joint step-size + diagonal mass-matrix warmup adaptation
(≙ advancedmh_tpu/samplers/hmc_adapt.py).

- Step size ε by Nesterov dual averaging toward the 0.65 acceptance optimum
  (Hoffman & Gelman 2014 §3.2; the recurrence of StepSizeAdaptation).
- Diagonal inverse mass M⁻¹ from the running Welford variance of the chain
  positions, shrunk toward a small multiple of the identity as Stan's
  windowed estimator does: ``(n/(n+5))·var + 1e-3·(5/(n+5))``.

The adaptation is continuous: every warmup step folds the new position into
the running moments and refreshes M⁻¹. With ``pooled=True`` all chains feed
one shared estimate by the Chan-Golub-LeVeque batch merge (stored
replicated over the chains, so the state layout matches per-chain). After
warmup both freeze: ε = exp(log ε̄) and the last regularised M⁻¹.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model
from ..utils.tree import tree_map
from .adapt import dual_average
from .base import GradientTransition, Sampler
from .hmc import HamiltonianMC


@dataclasses.dataclass(frozen=True)
class AdaptiveHMCState:
    """Inner HMC transition + dual-averaging stats + Welford mass moments."""

    inner: GradientTransition
    log_eps: torch.Tensor  # current log step size (warmup iterate)
    log_eps_bar: torch.Tensor  # running average, frozen post-warmup
    h_bar: torch.Tensor  # dual-averaging error sum H̄_t
    t: torch.Tensor  # warmup iteration counter (int32, starts at 1)
    mean: Any  # Welford running mean of positions (params-shaped)
    m2: Any  # Welford running sum of squared deviations
    n: torch.Tensor  # Welford observation count (float32)
    inverse_mass: Any  # current regularised diag(M⁻¹) estimate


def _bcast(count: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-chain count broadcast against a leaf's event dims."""
    return count.reshape(tuple(count.shape) + (1,) * (leaf.ndim - count.ndim))


@dataclasses.dataclass(frozen=True)
class AdaptiveHMC(Sampler):
    """Fixed-trajectory HMC with joint (ε, diag M⁻¹) warmup adaptation.

    ``pooled=True`` shares one mass estimate across the chain batch
    (cross-chain Welford merge); ε is still dual-averaged per chain."""

    n_leapfrog: int = 10
    target_accept: float = 0.65
    initial_step_size: float = 0.1
    pooled: bool = False
    t0: float = 10.0
    kappa: float = 0.75
    gamma: float = 0.05
    mu: Optional[float] = None
    mass_regularization: float = 5.0
    mass_warm_start: int = 10

    def __post_init__(self):
        if int(self.n_leapfrog) < 1:
            raise ValueError("n_leapfrog must be >= 1")
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
        if self.mass_regularization < 0.0:
            raise ValueError("mass_regularization must be non-negative")
        if int(self.mass_warm_start) < 0:
            raise ValueError("mass_warm_start must be non-negative")

    # -- helpers -----------------------------------------------------------

    @property
    def _mu(self) -> float:
        return math.log(10.0 * self.initial_step_size) if self.mu is None else self.mu

    def _hmc(self, step_size, inverse_mass) -> HamiltonianMC:
        return HamiltonianMC(step_size=step_size, n_leapfrog=self.n_leapfrog,
                             inverse_mass=inverse_mass)

    def transition_of(self, state: AdaptiveHMCState) -> GradientTransition:
        return state.inner

    def _dual_avg(self, state, accepted):
        """One HG14 update (elementwise: one chain or per-chain)."""
        return dual_average(state, accepted, self.target_accept, self.t0,
                            self.gamma, self.kappa, self._mu)

    def _regularized_inverse_mass(self, m2, n, prev):
        """Stan's shrunk variance estimate; keeps ``prev`` (the identity at
        init) until ``mass_warm_start`` observations have accumulated."""
        r = self.mass_regularization

        def leaf(m2_leaf, prev_leaf):
            nn = _bcast(torch.clamp(n, min=1.0), m2_leaf)
            var = m2_leaf / torch.clamp(nn - 1.0, min=1.0)
            est = (nn / (nn + r)) * var + 1e-3 * (r / (nn + r))
            use = _bcast(n >= float(self.mass_warm_start), m2_leaf)
            return torch.where(use, est, prev_leaf)

        return tree_map(leaf, m2, prev)

    @staticmethod
    def _welford_update(mean, m2, n, x):
        """Per-chain (or single-chain) Welford: one observation per chain."""
        n_new = n + 1.0
        mean_new = tree_map(lambda ml, xl: ml + (xl - ml) / _bcast(n_new, xl), mean, x)
        m2_new = tree_map(lambda m2l, ml, mnl, xl: m2l + (xl - ml) * (xl - mnl),
                          m2, mean, mean_new, x)
        return mean_new, m2_new, n_new

    @staticmethod
    def _welford_update_pooled(mean, m2, n, x, batch_shape):
        """Cross-chain pooled merge (Chan-Golub-LeVeque, diagonal case):

            M2' = M2 + Σ_c (x_c − x̄)² + (nC/(n+C))·δ²,  δ = x̄ − mean,

        moments replicated over the chains."""
        bn = len(batch_shape)
        C = float(math.prod(batch_shape))
        axes = tuple(range(bn))
        n0 = n.reshape(-1)[0]
        n_new = n0 + C

        def first(leaf):
            return leaf.reshape((-1,) + tuple(leaf.shape[bn:]))[0]

        def mean_leaf(mean_l, x_l):
            mean0 = first(mean_l)
            out = mean0 + (C / n_new) * (torch.mean(x_l, dim=axes) - mean0)
            return out.broadcast_to(x_l.shape).clone()

        def m2_leaf(m2_l, mean_l, x_l):
            mean0, m20 = first(mean_l), first(m2_l)
            b_mean = torch.mean(x_l, dim=axes)
            centered = x_l - b_mean
            delta = b_mean - mean0
            out = m20 + torch.sum(centered * centered, dim=axes) + (n0 * C / n_new) * delta * delta
            return out.broadcast_to(x_l.shape).clone()

        return (tree_map(mean_leaf, mean, x), tree_map(m2_leaf, m2, mean, x),
                n_new.broadcast_to(n.shape).clone())

    def _fresh(self, inner: GradientTransition, batch_shape) -> AdaptiveHMCState:
        dev = inner.lp.device
        log_eps0 = torch.log(torch.full(batch_shape, self.initial_step_size,
                                        dtype=torch.float32, device=dev))
        return AdaptiveHMCState(
            inner=inner, log_eps=log_eps0, log_eps_bar=log_eps0.clone(),
            h_bar=torch.zeros(batch_shape, dtype=torch.float32, device=dev),
            t=torch.ones(batch_shape, dtype=torch.int32, device=dev),
            mean=tree_map(lambda x: x.to(torch.float32).clone(), inner.params),
            m2=tree_map(torch.zeros_like, inner.params),
            n=torch.zeros(batch_shape, dtype=torch.float32, device=dev),
            inverse_mass=tree_map(torch.ones_like, inner.params),
        )

    def _adapted(self, state, inner, accepted, welford) -> AdaptiveHMCState:
        log_eps, log_eps_bar, h_bar = self._dual_avg(state, accepted)
        mean, m2, n = welford(state.mean, state.m2, state.n, inner.params)
        return AdaptiveHMCState(
            inner=inner, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar,
            t=state.t + 1, mean=mean, m2=m2, n=n,
            inverse_mass=self._regularized_inverse_mass(m2, n, state.inverse_mass))

    # -- one chain -----------------------------------------------------------

    def init(self, gen, model, initial_params: Optional[Any] = None):
        t, inner = self._hmc(self.initial_step_size, None).init(gen, model, initial_params)
        return t, self._fresh(inner, ())

    def step_warmup(self, gen, state: AdaptiveHMCState, model):
        model = as_model(model)
        spl = self._hmc(torch.exp(state.log_eps), state.inverse_mass)
        t_out, inner = spl.step(gen, state.inner, model)
        return t_out, self._adapted(state, inner, t_out.accepted, self._welford_update)

    def step(self, gen, state: AdaptiveHMCState, model):
        """Post-warmup: frozen ε = exp(log ε̄) and frozen M⁻¹."""
        spl = self._hmc(torch.exp(state.log_eps_bar), state.inverse_mass)
        t_out, inner = spl.step(gen, state.inner, as_model(model))
        return t_out, dataclasses.replace(state, inner=inner)

    # -- a chain batch -------------------------------------------------------

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...],
                     initial_params=None, init_batched: bool = False):
        t, inner = self._hmc(self.initial_step_size, None).init_batched(
            gen, model, batch_shape, initial_params, init_batched)
        return t, self._fresh(inner, tuple(batch_shape))

    def step_batched(self, gen, state: AdaptiveHMCState, model, batch_shape):
        spl = self._hmc(torch.exp(state.log_eps_bar), state.inverse_mass)
        t_out, inner = spl.step_batched(gen, state.inner, model, batch_shape)
        return t_out, dataclasses.replace(state, inner=inner)

    def step_warmup_batched(self, gen, state: AdaptiveHMCState, model, batch_shape):
        spl = self._hmc(torch.exp(state.log_eps), state.inverse_mass)
        t_out, inner = spl.step_batched(gen, state.inner, model, batch_shape)
        if self.pooled:
            def welford(mean, m2, n, x):
                return self._welford_update_pooled(mean, m2, n, x, batch_shape)
        else:
            welford = self._welford_update
        return t_out, self._adapted(state, inner, t_out.accepted, welford)
