"""Delayed-rejection Metropolis-Hastings (≙ advancedmh_tpu/samplers/dr.py;
Mira 2001, Haario et al. 2006).

When the first-stage proposal is rejected, a second proposal (typically a
narrower kernel) gets a try within the same step, with the acceptance
corrected so that the composite kernel keeps detailed balance:

    α₂ = min(1, π(y₂) q₁(y₁|y₂) (1 − α₁(y₂→y₁)) / [π(x) q₁(y₁|x) (1 − α₁(x→y₁))])

(q₂'s terms cancel because the second stage must be symmetric). Both stages
are evaluated on every step for every chain and stage 2 is masked in; the
1 − α₁ factors are taken in log space with a −1e30 floor
(``ops/dr.py::log1m_exp``), so masked lanes never meet inf − inf.

A step is its draws (the two proposals and two Exp(1)) then a deterministic
move (:meth:`DelayedRejection.dr_move`), so that a test can feed the move
the JAX package's own proposals.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, logdensity, logdensity_batched
from ..ops.dr import log1m_exp as _log1m_exp
from ..proposals import is_proposal, logratio_proposal_density, propose, propose_initial, q
from ..utils.tree import tree_flatten, tree_map
from .base import Sampler, Transition


@dataclasses.dataclass(frozen=True)
class DelayedRejection(Sampler):
    """Two-stage delayed-rejection MH over proposal trees (as in
    MetropolisHastings). ``first`` needs evaluable leaf densities (its cross
    densities q₁(y₁|y₂), q₁(y₁|x) enter the stage-2 ratio); ``second`` must
    be symmetric. Typical use: a bold Gaussian random walk first, the same
    shape about 5× narrower second."""

    first: Any
    second: Any

    def __post_init__(self):
        leaves, _ = tree_flatten(self.second, is_leaf=is_proposal)
        if not all(getattr(p, "symmetric", False) for p in leaves):
            raise ValueError(
                "DelayedRejection requires a symmetric second-stage proposal "
                "(its q₂ terms must cancel from the stage-2 ratio); use a "
                "zero-mean random-walk leaf or SymmetricRandomWalkProposal."
            )

    def init(self, gen, model, initial_params: Optional[Any] = None):
        model = as_model(model)
        params = propose_initial(gen, self.first) if initial_params is None else initial_params
        lp = logdensity(model, params)
        t = Transition(params, lp, torch.zeros((), dtype=torch.bool, device=lp.device))
        return t, t

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
        model = as_model(model)
        if initial_params is None:
            params = propose_initial(gen, self.first, batch_shape)
        elif init_batched:
            params = initial_params
        else:
            params = tree_map(lambda x: x.expand(batch_shape + tuple(x.shape)).clone(),
                              initial_params)
        lp = logdensity_batched(model, params)
        t = Transition(params, lp, torch.zeros(batch_shape, dtype=torch.bool, device=lp.device))
        return t, t

    def dr_move(self, x, lp0, y1, lp1, y2, lp2, e1, e2, batch_shape=()) -> Transition:
        """The deterministic move from (``x``, ``lp0``) given the two
        proposals with their log densities and the two accept tests'
        Exp(1) draws: stage 1 accepts iff −e₁ < la₁, stage 2 iff −e₂ < la₂
        and stage 1 did not."""
        bn = len(batch_shape)
        la1 = lp1 - lp0 + logratio_proposal_density(self.first, x, y1, batch_ndim=bn)
        acc1 = -e1 < la1
        # the reverse path's stage-1 acceptance α₁(y₂ → y₁)
        la1_rev = lp1 - lp2 + logratio_proposal_density(self.first, y2, y1, batch_ndim=bn)
        num = lp2 + q(self.first, y1, y2, batch_ndim=bn) + _log1m_exp(la1_rev)
        den = lp0 + q(self.first, y1, x, batch_ndim=bn) + _log1m_exp(la1)
        acc2 = (-e2 < num - den) & ~acc1

        def sel(a, b, c):
            m1 = acc1.reshape(tuple(batch_shape) + (1,) * (a.ndim - bn))
            m2 = acc2.reshape(tuple(batch_shape) + (1,) * (a.ndim - bn))
            return torch.where(m1, a, torch.where(m2, b, c))

        params = tree_map(sel, y1, y2, x)
        lp = torch.where(acc1, lp1, torch.where(acc2, lp2, lp0))
        return Transition(params, lp, acc1 | acc2)

    def step_batched(self, gen, state: Transition, model, batch_shape: Tuple[int, ...]):
        model = as_model(model)
        batch_shape = tuple(batch_shape)
        lp_fn = (lambda p: logdensity_batched(model, p)) if batch_shape else (
            lambda p: logdensity(model, p))
        x, lp0 = state.params, state.lp
        y1 = propose(gen, self.first, x, batch_shape)
        y2 = propose(gen, self.second, x, batch_shape)
        e1, e2 = (torch.empty(lp0.shape, device=gen.device).exponential_(generator=gen)
                  for _ in range(2))
        t = self.dr_move(x, lp0, y1, lp_fn(y1), y2, lp_fn(y2), e1, e2, batch_shape)
        return t, t

    def step(self, gen, state: Transition, model):
        return self.step_batched(gen, state, model, ())
