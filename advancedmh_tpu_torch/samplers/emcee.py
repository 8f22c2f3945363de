"""Affine-invariant ensemble sampler: emcee's stretch move and the
Goodman-Weare walk move (≙ advancedmh_tpu/samplers/emcee.py, reference
src/emcee.jl).

The reference moves walkers one after another; this is the red-black
(complementary-ensemble) form of Foreman-Mackey et al. (2013, §3): the
ensemble splits into two halves, each half moves in parallel against the
frozen other half, then the halves swap. It keeps detailed balance and the
reference's posterior moments, though not its draws. Each candidate costs
one density evaluation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from ..models.density import as_model, logdensity_batched
from ..proposals import as_static_proposal_tree, propose_initial
from ..utils.tree import tree_flatten, tree_map
from .base import Sampler, Transition


@dataclasses.dataclass(frozen=True)
class StretchProposal:
    """≙ ``StretchProposal(p, stretch_length=2.0)`` (src/emcee.jl:63-68):
    ``payload`` gives the initial per-walker prior draws; the move itself
    has one parameter, the Goodman-Weare ``a`` (``stretch_length``)."""

    payload: Any
    stretch_length: float = 2.0


@dataclasses.dataclass(frozen=True)
class WalkProposal:
    """The Goodman-Weare (2010) walk move (emcee's ``WalkMove``; beyond the
    reference): x' = x + scale·(1/√H)·Σ_j z_j (x_j − x̄) over the frozen
    other half, z_j iid N(0, 1). Symmetric given that half, so acceptance
    is plain Δlp. ``payload`` seeds the initial draws."""

    payload: Any
    scale: float = 1.0


def _select(accepted, new, old):
    return tree_map(lambda a, b: torch.where(
        accepted.reshape(accepted.shape + (1,) * (a.ndim - 1)), a, b), new, old)


@dataclasses.dataclass(frozen=True)
class Ensemble(Sampler):
    """≙ ``Ensemble(n_walkers, proposal)`` (src/emcee.jl:1-4), ``proposal``
    a :class:`StretchProposal` or :class:`WalkProposal`."""

    n_walkers: int
    proposal: Any

    is_population = True

    @staticmethod
    def _dim_of(params) -> int:
        """Per-walker dimension (the n of the Jacobian (n−1)·log z,
        src/emcee.jl:82-83)."""
        leaves, _ = tree_flatten(params)
        return int(sum(int(np.prod(leaf.shape[1:])) for leaf in leaves))

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """≙ the initial draw (src/emcee.jl:29-34): each walker from the
        payload as a static prior draw, unless ``initial_params`` (with a
        leading walker axis) is given."""
        model = as_model(model)
        if initial_params is None:
            static = as_static_proposal_tree(self.proposal.payload)
            params = propose_initial(gen, static, (self.n_walkers,))
        else:
            params = initial_params
            got = tree_flatten(params)[0][0].shape[0]
            if got != self.n_walkers:
                raise ValueError(
                    f"initial_params carries {got} walkers but the Ensemble "
                    f"was built with n_walkers={self.n_walkers}"
                )
        lp = logdensity_batched(model, params)
        t = Transition(params, lp, torch.zeros((self.n_walkers,), dtype=torch.bool,
                                               device=lp.device))
        return t, t

    def _half_move(self, gen, active, active_lp, other, model):
        """Move one half in parallel against the frozen other half."""
        n_active = active_lp.shape[0]
        n_other = tree_flatten(other)[0][0].shape[0]
        device = active_lp.device
        if isinstance(self.proposal, WalkProposal):
            z = torch.randn((n_active, n_other), generator=gen, device=device)
            coef = self.proposal.scale / math.sqrt(float(n_other))

            def walk(xi, xo):
                c = xo - xo.mean(dim=0, keepdim=True)
                return xi + coef * (z @ c.reshape(n_other, -1)).reshape(xi.shape)

            y = tree_map(walk, active, other)
            lp_y = logdensity_batched(model, y)
            logalpha = lp_y - active_lp
        else:
            a = self.proposal.stretch_length
            j = torch.randint(0, n_other, (n_active,), generator=gen, device=device)
            u = torch.rand((n_active,), generator=gen, device=device)
            z = torch.square((a - 1.0) * u + 1.0) / a  # src/emcee.jl:84

            def stretch(xo, xi):
                partner = xo[j]
                return partner + z.reshape((n_active,) + (1,) * (xi.ndim - 1)) * (xi - partner)

            y = tree_map(stretch, other, active)
            lp_y = logdensity_batched(model, y)
            logalpha = (self._dim_of(active) - 1) * torch.log(z) + lp_y - active_lp
        # accept iff −randexp ≤ logα (src/emcee.jl:85-93: ≤, unlike mh-core's <)
        e = torch.empty((n_active,), device=device).exponential_(generator=gen)
        accepted = -e <= logalpha
        return (_select(accepted, y, active), torch.where(accepted, lp_y, active_lp),
                accepted)

    def step(self, gen, state: Transition, model):
        """One ensemble update: the two complementary half-moves."""
        model = as_model(model)
        h = self.n_walkers // 2
        pA = tree_map(lambda x: x[:h], state.params)
        pB = tree_map(lambda x: x[h:], state.params)
        pA, lpA, accA = self._half_move(gen, pA, state.lp[:h], pB, model)
        pB, lpB, accB = self._half_move(gen, pB, state.lp[h:], pA, model)
        t = Transition(tree_map(lambda x, y: torch.cat([x, y]), pA, pB),
                       torch.cat([lpA, lpB]), torch.cat([accA, accB]))
        return t, t
