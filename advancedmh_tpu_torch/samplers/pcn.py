"""Preconditioned Crank-Nicolson MH (≙ advancedmh_tpu/samplers/pcn.py; Cotter
et al. 2013, Beskos et al. 2008).

For targets likelihood × Gaussian prior (the ``EllipticalSlice`` contract:
the model's density is the log-likelihood only) the proposal

    x' = m + √(1−β²)·(x − m) + β·(ν − m),        ν ~ N(m, C)  (the prior)

is reversible with respect to the prior, so the acceptance ratio is the
likelihood difference only; β ∈ (0, 1] sets the mixing whatever the
dimension. One likelihood evaluation a step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, logdensity, logdensity_batched
from .base import Sampler, Transition, select_tree
from .ess import EllipticalSlice, matched_leaves, prior_noise


@dataclasses.dataclass(frozen=True)
class PreconditionedCrankNicolson(Sampler):
    """``PreconditionedCrankNicolson(prior, beta=0.2)``: ``prior`` a Normal /
    MvNormal or a tree of them matching the params tree; β → 0 is a timid
    prior-preserving walk, β = 1 independent prior resampling."""

    prior: Any
    beta: float = 0.2

    def __post_init__(self):
        if not 0.0 < self.beta <= 1.0:
            raise ValueError(f"beta must be in (0, 1], got {self.beta}")

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """Draw the start from the prior unless ``initial_params`` is given."""
        return EllipticalSlice(self.prior).init(gen, model, initial_params)

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
        return EllipticalSlice(self.prior).init_batched(gen, model, batch_shape,
                                                        initial_params, init_batched)

    def proposal(self, params, nu):
        """x' = m + ρ·(x − m) + β·(ν − m) per leaf, from the prior draws
        ``nu`` (leaves of the params' shapes)."""
        dists, leaves, unflatten = matched_leaves(self.prior, params)
        rho = math.sqrt(1.0 - self.beta * self.beta)
        out = []
        for d, x, n in zip(dists, leaves, nu):
            m = torch.as_tensor(d.loc, dtype=x.dtype, device=x.device)
            out.append(m + rho * (x - m) + self.beta * (n - m))
        return unflatten(out)

    def step_from_noise(self, state: Transition, model, batch_shape, nu, e):
        """One step from the prior draws ``nu`` and the accept test's Exp(1)
        draws ``e``: accept iff −e < ℓ(x') − ℓ(x)."""
        model = as_model(model)
        cand = self.proposal(state.params, nu)
        lp_c = logdensity_batched(model, cand) if batch_shape else logdensity(model, cand)
        accepted = -e < lp_c - state.lp
        t = Transition(select_tree(accepted, cand, state.params),
                       torch.where(accepted, lp_c, state.lp), accepted)
        return t, t

    def step_batched(self, gen, state: Transition, model, batch_shape: Tuple[int, ...]):
        dists, leaves, _ = matched_leaves(self.prior, state.params)
        nu = prior_noise(dists, leaves, gen)
        e = torch.empty(tuple(batch_shape), device=gen.device).exponential_(generator=gen)
        return self.step_from_noise(state, model, batch_shape, nu, e)

    def step(self, gen, state: Transition, model):
        return self.step_batched(gen, state, model, ())
