"""Robust Adaptive Metropolis (Vihola 2012; ≙ advancedmh_tpu/samplers/ram.py,
reference src/RobustAdaptiveMetropolis.jl).

Proposal ``x' = x + S·U`` with ``U ~ N(0, I)``; during warmup the
lower-triangular ``S`` adapts by a rank-1 Cholesky update/downdate sized to
coerce the acceptance rate to ``alpha`` (default 0.234), and keeps the old
``S`` when the adapted factor leaves the eigenvalue bounds or the downdate
fails. The only sampler whose warmup step differs from its step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, logdensity, logdensity_batched
from ..ops.cholesky import chol_rank1_update, chol_rank1_update_batched
from .base import Sampler, Transition


@dataclasses.dataclass(frozen=True)
class RobustAdaptiveMetropolisState:
    """≙ ``RobustAdaptiveMetropolisState`` (src/RobustAdaptiveMetropolis.jl:99-114)."""

    x: torch.Tensor  # current realization of the chain
    logprob: torch.Tensor  # log density of x
    S: torch.Tensor  # current lower-triangular Cholesky factor
    logalpha: torch.Tensor  # log acceptance ratio of the previous iteration
    eta: torch.Tensor  # current adaptation step size
    iteration: torch.Tensor  # current iteration (int32)
    isaccept: torch.Tensor  # whether the previous iteration was accepted


def _bmv(S: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """S·U over leading batch axes, as float32 multiplies and adds (no
    matmul unit, so no TF32)."""
    return (S * U[..., None, :]).sum(-1)


@dataclasses.dataclass(frozen=True)
class RobustAdaptiveMetropolis(Sampler):
    """≙ the ``RobustAdaptiveMetropolis`` sampler (src/RobustAdaptiveMetropolis.jl:75-87).

    ``pooled=True`` adapts one S shared by all chains of a batch, by the
    rank-C average of the per-chain corrections (batched path only)."""

    alpha: float = 0.234  # target acceptance rate
    gamma: float = 0.6  # negative exponent of the adaptation decay
    S: Optional[Any] = None  # initial Cholesky factor (None → identity)
    eigenvalue_lower_bound: float = 0.0
    eigenvalue_upper_bound: float = math.inf
    pooled: bool = False

    @property
    def has_bounds(self) -> bool:
        """Whether the eigenvalue bounds differ from the default (0, ∞)."""
        return not (self.eigenvalue_lower_bound == 0.0
                    and math.isinf(self.eigenvalue_upper_bound))

    def _dim(self, model, initial_params) -> int:
        if initial_params is not None:
            return int(initial_params.shape[-1])
        if model.dimension is not None:
            return int(model.dimension)
        raise ValueError(
            "RobustAdaptiveMetropolis needs the model dimension: pass "
            "initial_params or set DensityModel(dimension=...)."
        )

    def initial_S(self, d: int, device) -> torch.Tensor:
        if self.S is None:
            return torch.eye(d, dtype=torch.float32, device=device)
        S = torch.as_tensor(self.S, dtype=torch.float32).to(device)
        if tuple(S.shape) != (d, d):
            raise ValueError("The provided `S` has the wrong dimensionality.")
        return torch.tril(S)

    def transition_of(self, state: RobustAdaptiveMetropolisState) -> Transition:
        return Transition(state.x, state.logprob, state.isaccept)

    # -- one chain ---------------------------------------------------------

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """≙ step-init (src/RobustAdaptiveMetropolis.jl:175-214)."""
        model = as_model(model)
        d = self._dim(model, initial_params)
        if initial_params is None:
            x = torch.randn((d,), generator=gen, device=gen.device)
        else:
            x = torch.as_tensor(initial_params, dtype=torch.float32)
        S = self.initial_S(d, x.device)
        lp = logdensity(model, x)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        one = torch.ones((), dtype=torch.bool, device=x.device)
        state = RobustAdaptiveMetropolisState(
            x=x, logprob=lp, S=S, logalpha=zero, eta=zero,
            iteration=torch.ones((), dtype=torch.int32, device=x.device),
            isaccept=one,
        )
        return Transition(x, lp, one), state

    def _step_inner(self, gen, state, lp_fn):
        """≙ ``ram_step_inner`` (src/RobustAdaptiveMetropolis.jl:123-151);
        logα = min(lp' − lp, 0) is a true log acceptance probability."""
        x = state.x
        U = torch.randn(x.shape, generator=gen, device=gen.device)
        x_new = _bmv(state.S, U) + x
        lp_new = lp_fn(x_new)
        logalpha = torch.minimum(lp_new - state.logprob, torch.zeros_like(lp_new))
        e = torch.empty(logalpha.shape, device=gen.device).exponential_(generator=gen)
        return x_new, lp_new, U, logalpha, e > -logalpha

    def _adapt(self, state, logalpha, U):
        """≙ ``ram_adapt`` (src/RobustAdaptiveMetropolis.jl:153-173)."""
        dalpha = torch.exp(logalpha) - self.alpha
        S = state.S
        eta = torch.pow(state.iteration.to(S.dtype), -self.gamma)
        dS = torch.sqrt(eta * torch.abs(dalpha)) * _bmv(S, U) / torch.linalg.norm(U)
        S_new, ok = chol_rank1_update(S, dS, torch.sign(dalpha))
        return S_new, eta, ok

    def _valid_eigenvalues(self, S) -> torch.Tensor:
        """≙ ``valid_eigenvalues`` (src/RobustAdaptiveMetropolis.jl:239-245):
        a triangular factor's eigenvalues are its diagonal; the default
        (0, ∞) bounds are not checked."""
        if not self.has_bounds:
            return torch.ones(S.shape[:-2], dtype=torch.bool, device=S.device)
        diag = torch.diagonal(S, dim1=-2, dim2=-1)
        return torch.all((diag >= self.eigenvalue_lower_bound)
                         & (diag <= self.eigenvalue_upper_bound), dim=-1)

    def _next(self, state, x_new, lp_new, logalpha, isaccept, S, eta):
        acc = isaccept[..., None]
        new = RobustAdaptiveMetropolisState(
            x=torch.where(acc, x_new, state.x),
            logprob=torch.where(isaccept, lp_new, state.logprob),
            S=S, logalpha=logalpha, eta=eta,
            iteration=state.iteration + 1, isaccept=isaccept,
        )
        return self.transition_of(new), new

    def step(self, gen, state, model):
        """Post-warmup step: S frozen (≙ src/RobustAdaptiveMetropolis.jl:216-237)."""
        model = as_model(model)
        x_new, lp_new, _, logalpha, isaccept = self._step_inner(
            gen, state, lambda x: logdensity(model, x))
        return self._next(state, x_new, lp_new, logalpha, isaccept, state.S, state.eta)

    def step_warmup(self, gen, state, model):
        """Warmup step with adaptation (≙ src/RobustAdaptiveMetropolis.jl:247-278)."""
        model = as_model(model)
        x_new, lp_new, U, logalpha, isaccept = self._step_inner(
            gen, state, lambda x: logdensity(model, x))
        S_new, eta, ok = self._adapt(state, logalpha, U)
        valid = ok & self._valid_eigenvalues(S_new)
        S = torch.where(valid, S_new, state.S)
        return self._next(state, x_new, lp_new, logalpha, isaccept, S, eta)

    # -- a chain batch -------------------------------------------------------

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...],
                     initial_params=None, init_batched: bool = False):
        model = as_model(model)
        d = self._dim(model, initial_params)
        if initial_params is None:
            x = torch.randn(batch_shape + (d,), generator=gen, device=gen.device)
        elif init_batched:
            x = initial_params
        else:
            x = initial_params.expand(batch_shape + (d,)).clone()
        S = self.initial_S(d, x.device).expand(batch_shape + (d, d)).clone()
        lp = logdensity_batched(model, x)
        zeros = torch.zeros(batch_shape, dtype=x.dtype, device=x.device)
        ones = torch.ones(batch_shape, dtype=torch.bool, device=x.device)
        state = RobustAdaptiveMetropolisState(
            x=x, logprob=lp, S=S, logalpha=zeros, eta=zeros,
            iteration=torch.ones(batch_shape, dtype=torch.int32, device=x.device),
            isaccept=ones,
        )
        return Transition(x, lp, ones), state

    def step_batched(self, gen, state, model, batch_shape):
        model = as_model(model)
        x_new, lp_new, _, logalpha, isaccept = self._step_inner(
            gen, state, lambda x: logdensity_batched(model, x))
        return self._next(state, x_new, lp_new, logalpha, isaccept, state.S, state.eta)

    def _adapt_pooled(self, state, logalpha, U):
        """Rank-C pooled Vihola update: S'S'ᵀ = S(I + η·W)Sᵀ with
        W = mean_c Δα_c û_c û_cᵀ, û = U/‖U‖. ‖W‖₂ < 1 and η ≤ 1, so I + ηW
        is positive definite and its d×d factorisation cannot fail. Both
        products run as float32 multiplies and adds (no TF32), where the JAX
        package asks for ``Precision.HIGHEST``: a truncated chol(I + ηW)
        rounds to I once η‖W‖ is small, and adaptation would freeze."""
        d = U.shape[-1]
        Uf = U.reshape(-1, d)
        C = Uf.shape[0]
        S0 = state.S.reshape(-1, d, d)[0]
        eta = torch.pow(state.iteration.reshape(-1)[0].to(S0.dtype), -self.gamma)
        dalpha = torch.exp(logalpha.reshape(-1)) - self.alpha
        u = Uf / torch.linalg.norm(Uf, dim=-1, keepdim=True)
        W = ((u * dalpha[:, None])[:, :, None] * u[:, None, :]).sum(0) / C
        M = torch.eye(d, dtype=S0.dtype, device=S0.device) + eta * W
        chol, _ = torch.linalg.cholesky_ex(M)
        S_new = (S0[:, :, None] * chol[None, :, :]).sum(1)
        S_final = torch.where(self._valid_eigenvalues(S_new), S_new, S0)
        return S_final.expand(state.S.shape).clone(), eta

    def step_warmup_batched(self, gen, state, model, batch_shape):
        model = as_model(model)
        x_new, lp_new, U, logalpha, isaccept = self._step_inner(
            gen, state, lambda x: logdensity_batched(model, x))
        if self.pooled:
            S, eta = self._adapt_pooled(state, logalpha, U)
            return self._next(state, x_new, lp_new, logalpha, isaccept, S,
                              eta.expand(batch_shape).clone())
        # per-chain adaptation: each chain adapts its own S
        dalpha = torch.exp(logalpha) - self.alpha
        S = state.S
        eta = torch.pow(state.iteration.to(S.dtype), -self.gamma)
        scale = torch.sqrt(eta * torch.abs(dalpha)) / torch.linalg.norm(U, dim=-1)
        S_new, ok = chol_rank1_update_batched(S, scale[..., None] * _bmv(S, U),
                                              torch.sign(dalpha))
        valid = ok & self._valid_eigenvalues(S_new)
        S = torch.where(valid[..., None, None], S_new, S)
        return self._next(state, x_new, lp_new, logalpha, isaccept, S, eta)
