"""Generic Metropolis-Hastings kernel (≙ advancedmh_tpu/samplers/mh.py,
reference src/mh-core.jl).

One step: propose → logdensity → Hastings ratio → branchless accept/reject.
``step_batched`` runs it over a chain batch with one generator per step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..distributions import MvNormal, Normal
from ..models.density import as_model, logdensity, logdensity_batched
from ..proposals import (
    RandomWalkProposal,
    StaticProposal,
    logratio_proposal_density,
    propose,
    propose_initial,
)
from ..utils.tree import tree_map
from .base import Sampler, Transition, accept_reject, select_tree


@dataclasses.dataclass(frozen=True)
class MetropolisHastings(Sampler):
    """≙ ``MetropolisHastings(proposal)`` (src/mh-core.jl:44-46).

    ``proposal`` is a :class:`Proposal` leaf or a dict / tuple / list tree of
    proposals; samples come back in the shape of the proposal.
    """

    proposal: Any

    def init(
        self, gen, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        """First step (src/mh-core.jl:76-86): draw from the proposal unless
        ``initial_params`` is given."""
        model = as_model(model)
        params = (
            propose_initial(gen, self.proposal)
            if initial_params is None
            else initial_params
        )
        lp = logdensity(model, params)
        t = Transition(params, lp, torch.zeros((), dtype=torch.bool, device=lp.device))
        return t, t

    def init_batched(
        self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
        init_batched: bool = False,
    ) -> Tuple[Transition, Transition]:
        """Initial state of a chain batch: a batched draw from the proposal,
        or ``initial_params`` (one point broadcast to all chains, or one per
        chain when ``init_batched``)."""
        model = as_model(model)
        if initial_params is None:
            params = propose_initial(gen, self.proposal, batch_shape)
        elif init_batched:
            params = initial_params
        else:
            params = tree_map(
                lambda x: x.expand(batch_shape + tuple(x.shape)).clone(),
                initial_params,
            )
        lp = logdensity_batched(model, params)
        t = Transition(params, lp, torch.zeros(batch_shape, dtype=torch.bool, device=lp.device))
        return t, t

    def step(self, gen, state: Transition, model) -> Tuple[Transition, Transition]:
        """Subsequent steps (src/mh-core.jl:92-117)."""
        model = as_model(model)
        candidate = propose(gen, self.proposal, state.params)
        lp_candidate = logdensity(model, candidate)
        logalpha = (
            lp_candidate
            - state.lp
            + logratio_proposal_density(self.proposal, state.params, candidate)
        )
        accepted = accept_reject(gen, logalpha)
        params = select_tree(accepted, candidate, state.params)
        lp = torch.where(accepted, lp_candidate, state.lp)
        t = Transition(params, lp, accepted)
        return t, t

    def step_batched(
        self, gen, state: Transition, model, batch_shape: Tuple[int, ...]
    ) -> Tuple[Transition, Transition]:
        """One step over a chain batch (≙ ``vmap(step)`` with batched RNG)."""
        model = as_model(model)
        candidate = propose(gen, self.proposal, state.params, batch_shape)
        lp_candidate = logdensity_batched(model, candidate)
        logalpha = (
            lp_candidate
            - state.lp
            + logratio_proposal_density(
                self.proposal, state.params, candidate, batch_ndim=len(batch_shape)
            )
        )
        accepted = accept_reject(gen, logalpha)
        params = select_tree(accepted, candidate, state.params)
        lp = torch.where(accepted, lp_candidate, state.lp)
        t = Transition(params, lp, accepted)
        return t, t


def StaticMH(d, device="cuda") -> MetropolisHastings:
    """≙ ``StaticMH`` (src/mh-core.jl:48-49): independence sampler;
    ``StaticMH(k)`` uses a standard k-dim MvNormal on ``device``."""
    if isinstance(d, int):
        d = MvNormal.standard(d, device)
    return MetropolisHastings(StaticProposal(d))


def _provably_symmetric_increment(payload) -> bool:
    """A zero-mean Gaussian increment gives q(x'|x) = q(x|x'), so its
    Hastings term is 0 and the flag can be set when the sampler is built."""
    if isinstance(payload, (MvNormal, Normal)):
        loc = payload.loc
        if isinstance(loc, torch.Tensor):
            loc = loc.detach().cpu().numpy()
        return bool(np.allclose(np.asarray(loc), 0.0))
    return False


def RWMH(d, device="cuda") -> MetropolisHastings:
    """≙ ``RWMH`` (src/mh-core.jl:50-51): random-walk Metropolis;
    ``RWMH(k)`` uses a standard k-dim MvNormal increment on ``device``.
    Zero-mean Gaussian increments are flagged symmetric."""
    if isinstance(d, int):
        d = MvNormal.standard(d, device)
    return MetropolisHastings(
        RandomWalkProposal(d, symmetric=_provably_symmetric_increment(d))
    )
