"""MEADS: Maximum-Eigenvalue Adaptation of Damping and Step size
(≙ advancedmh_tpu/samplers/meads.py; Hoffman & Sountsov, AISTATS 2022).

Generalized HMC (one leapfrog step per iteration, persistent partially
refreshed momentum) whose tuning is recomputed every step from cross-chain
statistics of a complementary fold of chains:

- preconditioner σ: the per-coordinate standard deviation of the fold's
  positions;
- step size ε = a·λ̂_g^{-1/2}, λ̂_g the soft maximum eigenvalue of the
  second moment of the preconditioned gradients (a = step_size_multiplier);
- damping γ = λ̂_x^{-1/2} from the normalised positions, refresh fraction
  α = 1 − e^{−2εγ}, slice drift δ = α/2.

λ̂ = tr(A²)/tr(A) with the unbiased pair estimate of tr(A²): one Gram
matrix (full float32, no TF32). The chains form ``n_folds`` contiguous
folds; fold k is tuned by fold k − 1 (mod K) and the folds move one after
another within an iteration, so each conditional kernel leaves the target
invariant while adapting forever: there is no warmup.

Acceptance: ``"nonreversible"`` (Neal 2020) keeps a persistent u ∈ [0, 1),
accepts iff u < a, renews u to u/a or (u − a)/(1 − a) and drifts it by δ
(mod 1); ``"metropolis"`` is the fresh ``−randexp < logα`` test. Rejections
negate the momentum. Array params only (a (d,) vector per chain); there is
no single-chain signal, so ``step`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, logdensity_and_gradient
from .base import Sampler, Transition
from .mala import value_and_grad_batched

_TINY = 1e-30
_PYTREE = ("MEADS supports array params (a (d,) vector per chain); pytree params "
           "are out of scope (module docstring).")


@dataclasses.dataclass(frozen=True)
class MEADSState:
    """Per-chain GHMC state: position, density, gradient, and the two
    persistent variables (normalised momentum p ~ N(0, I) and Neal's slice
    u ~ U[0, 1)) that make the kernel non-reversible."""

    x: torch.Tensor  # (d,) position (chain-batched by the runtime)
    lp: torch.Tensor  # log density at x
    grad: torch.Tensor  # (d,) gradient at x
    p: torch.Tensor  # (d,) persistent momentum, normalised space
    u: torch.Tensor  # persistent slice variable in [0, 1)
    iteration: torch.Tensor  # int32, 1-based (drives the early damping floor)
    isaccept: torch.Tensor  # previous step's accept flag


@dataclasses.dataclass(frozen=True)
class MEADS(Sampler):
    """Tuning-free generalized HMC with cross-fold adaptation (module
    docstring). ``n_folds`` ≙ the paper's K = 4; ``step_size_multiplier``
    the ½ of ε = ½λ̂^{-1/2}; ``step_size_clip`` caps ε in normalised space;
    ``damping_slowdown`` scales the early floor γ ≥ slowdown/(ε·(t + 1))."""

    n_folds: int = 4
    step_size_multiplier: float = 0.5
    step_size_clip: float = 1.0
    damping_slowdown: float = 1.0
    diagonal_preconditioning: bool = True
    accept: str = "nonreversible"  # or "metropolis"

    def __post_init__(self):
        if self.n_folds < 2:
            raise ValueError("MEADS needs n_folds >= 2")
        if self.step_size_multiplier <= 0.0:
            raise ValueError("step_size_multiplier must be positive")
        if self.accept not in ("nonreversible", "metropolis"):
            raise ValueError(
                f"accept must be 'nonreversible' or 'metropolis', got {self.accept!r}")

    def transition_of(self, state: MEADSState) -> Transition:
        return Transition(state.x, state.lp, state.isaccept)

    # -- init ------------------------------------------------------------------

    @staticmethod
    def _array_params(model, initial_params, shape, gen) -> torch.Tensor:
        if initial_params is None:
            if model.dimension is None:
                raise ValueError(
                    "MEADS needs the model dimension: pass initial_params or set "
                    "DensityModel(dimension=...).")
            return torch.randn(tuple(shape) + (int(model.dimension),), generator=gen,
                               device=gen.device)
        if not isinstance(initial_params, torch.Tensor):
            raise ValueError(_PYTREE)
        return initial_params.to(torch.float32)

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """One chain; p from its stationary N(0, I), u from U[0, 1)."""
        model = as_model(model)
        x = self._array_params(model, initial_params, (), gen)
        if x.ndim != 1:
            raise ValueError(_PYTREE)
        lp, grad = logdensity_and_gradient(model, x)
        dev = lp.device
        state = MEADSState(
            x=x, lp=lp, grad=grad,
            p=torch.randn(x.shape, generator=gen, device=gen.device),
            u=torch.rand((), generator=gen, device=gen.device),
            iteration=torch.ones((), dtype=torch.int32, device=dev),
            isaccept=torch.ones((), dtype=torch.bool, device=dev))
        return Transition(x, lp, state.isaccept), state

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...],
                     initial_params=None, init_batched: bool = False):
        model = as_model(model)
        x = self._array_params(model, initial_params, batch_shape, gen)
        if initial_params is not None and not init_batched:
            if x.ndim != 1:
                raise ValueError(_PYTREE)
            x = x.expand(tuple(batch_shape) + tuple(x.shape)).clone()
        if x.ndim != len(batch_shape) + 1:
            raise ValueError(_PYTREE)
        lp, grad = value_and_grad_batched(model, x)
        dev = lp.device
        state = MEADSState(
            x=x, lp=lp, grad=grad,
            p=torch.randn(x.shape, generator=gen, device=gen.device),
            u=torch.rand(tuple(batch_shape), generator=gen, device=gen.device),
            iteration=torch.ones(tuple(batch_shape), dtype=torch.int32, device=dev),
            isaccept=torch.ones(tuple(batch_shape), dtype=torch.bool, device=dev))
        return Transition(x, lp, state.isaccept), state

    def step(self, gen, state, model):
        raise ValueError(
            "MEADS adapts every parameter from complementary chain folds - there is "
            f"no single-chain signal. Run it with num_chains >= 2*n_folds "
            f"({2 * self.n_folds}) on the vectorized path (the default chain_method).")

    # -- the fold kernel ---------------------------------------------------------

    @staticmethod
    def _max_eig(v: torch.Tensor) -> torch.Tensor:
        """Soft maximum eigenvalue of A = E[v vᵀ] from F row samples:
        tr(A²)/tr(A) with the unbiased i≠j pair estimate of tr(A²)
        (Hoffman-Sountsov 2022 §3.1). One (d, F)·(F, d) Gram matrix."""
        F = v.shape[0]
        G = torch.matmul(v.T, v)
        row2 = torch.sum(v * v, dim=1)
        tr_a = torch.sum(row2) / F
        tr_a2 = (torch.sum(G * G) - torch.sum(row2 * row2)) / (F * (F - 1))
        return tr_a2 / torch.clamp(tr_a, min=_TINY)

    def _fold_parameters(self, xb, gb, it):
        """(σ, ε, α, δ) for the fold being moved, from the complementary
        fold's positions ``xb`` and gradients ``gb`` (F, d)."""
        if self.diagonal_preconditioning:
            sigma = torch.clamp(torch.std(xb, dim=0, correction=0), min=1e-10)
        else:
            sigma = torch.ones(xb.shape[-1], dtype=xb.dtype, device=xb.device)
        lam_g = self._max_eig(gb * sigma)
        eps = self.step_size_multiplier * torch.rsqrt(torch.clamp(lam_g, min=_TINY))
        eps = torch.clamp(eps, max=self.step_size_clip)
        z = (xb - torch.mean(xb, dim=0)) / sigma
        lam_x = self._max_eig(z)
        gamma = torch.rsqrt(torch.clamp(lam_x, min=1.0))
        # early floor: with t small the spread understates the slow modes
        gamma = torch.maximum(gamma, self.damping_slowdown / (eps * (it.to(xb.dtype) + 1.0)))
        alpha = 1.0 - torch.exp(-2.0 * eps * gamma)
        return sigma, eps, alpha, 0.5 * alpha

    def _ghmc_fold(self, z, e, xk, lpk, gk, pk, uk, vg, sigma, eps, alpha, delta):
        """One GHMC step for a fold from its noise (normals ``z`` (F, d) and,
        for the Metropolis accept, Exp(1) draws ``e`` (F,)): partial
        momentum refresh, one preconditioned leapfrog step, the slice (or
        Metropolis) accept, momentum negated on rejection."""
        p1 = torch.sqrt(1.0 - alpha) * pk + torch.sqrt(alpha) * z
        ph = p1 + (0.5 * eps) * (sigma * gk)
        y = xk + eps * (sigma * ph)
        lp_y, g_y = vg(y)
        p2 = ph + (0.5 * eps) * (sigma * g_y)
        ke1 = 0.5 * torch.sum(p1 * p1, dim=1)
        ke2 = 0.5 * torch.sum(p2 * p2, dim=1)
        logalpha = (lp_y - ke2) - (lpk - ke1)
        # divergences (non-finite logα) count as acceptance probability 0
        a = torch.where(torch.abs(logalpha) < 1e30, torch.exp(torch.clamp(logalpha, max=0.0)),
                        torch.zeros_like(logalpha))
        if self.accept == "nonreversible":
            acc = uk < a
            u_new = torch.where(acc, uk / torch.clamp(a, min=_TINY),
                                (uk - a) / torch.clamp(1.0 - a, min=_TINY))
            u_next = torch.remainder(u_new + delta, 1.0)
        else:
            acc = -e < logalpha
            u_next = uk
        mask = acc[:, None]
        return (torch.where(mask, y, xk), torch.where(acc, lp_y, lpk),
                torch.where(mask, g_y, gk), torch.where(mask, p2, -p1), u_next, acc)

    def step_batched_from_noise(self, state: MEADSState, model, batch_shape, zs, es):
        """One MEADS iteration from the folds' noise: ``zs[k]`` (F, d) and
        ``es[k]`` (F,) (or None under the nonreversible accept). Fold k is
        tuned by fold k − 1's current state (the sequential sweep)."""
        C, K = batch_shape[0], self.n_folds
        if C % K != 0 or C // K < 2:
            raise ValueError(
                f"MEADS needs num_chains divisible by n_folds={K} with >= 2 chains per "
                f"fold (got {C}).")
        model = as_model(model)
        vg = lambda y: value_and_grad_batched(model, y)
        it = state.iteration.reshape(-1)[0]
        split = lambda a: list(torch.split(a, C // K, dim=0))
        xs, lps, gs, ps, us = (split(a) for a in (state.x, state.lp, state.grad, state.p,
                                                 state.u))
        accs = [None] * K
        for k in range(K):
            b = (k - 1) % K
            sigma, eps, alpha, delta = self._fold_parameters(xs[b], gs[b], it)
            xs[k], lps[k], gs[k], ps[k], us[k], accs[k] = self._ghmc_fold(
                zs[k], es[k], xs[k], lps[k], gs[k], ps[k], us[k], vg, sigma, eps, alpha,
                delta)
        new = MEADSState(x=torch.cat(xs), lp=torch.cat(lps), grad=torch.cat(gs),
                         p=torch.cat(ps), u=torch.cat(us), iteration=state.iteration + 1,
                         isaccept=torch.cat(accs))
        return self.transition_of(new), new

    def step_batched(self, gen, state: MEADSState, model, batch_shape: Tuple[int, ...]):
        C, K = batch_shape[0], self.n_folds
        F, d = C // K, state.x.shape[-1]
        zs, es = [], []
        for _ in range(K):
            zs.append(torch.randn((F, d), generator=gen, device=gen.device))
            es.append(torch.empty((F,), device=gen.device).exponential_(generator=gen)
                      if self.accept == "metropolis" else None)
        return self.step_batched_from_noise(state, model, batch_shape, zs, es)
