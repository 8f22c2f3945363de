"""Metropolis-adjusted Langevin algorithm (≙ advancedmh_tpu/samplers/mala.py,
reference src/MALA.jl).

The proposal is a function of the gradient at the current state, e.g.::

    MALA(lambda g: MvNormal(0.5 * s2 * g, scale=math.sqrt(s2)))

≙ the reference's ``MALA(g -> MvNormal(σ²/2 .* g, σ²*I))``. Gradients come
from torch autograd or from a model's ``logdensity_and_gradient_fn``; the
gradient is cached in the transition, so a step costs one value-and-gradient
evaluation (≙ src/MALA.jl:73-75).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models.density import as_model, check_capabilities, logdensity_and_gradient
from ..proposals import RandomWalkProposal, is_proposal, propose, q
from ..proposals.core import _resolve
from ..utils.tree import flatten_up_to, tree_flatten, tree_map
from .base import GradientTransition, Sampler, accept_reject, select_tree


def _resolve_tree(proposal_tree, conditioner):
    """Resolve every functional leaf against the matching ``conditioner``
    leaf (for MALA the conditioner is the gradient, ≙ src/MALA.jl:70)."""
    leaves, unflatten = tree_flatten(proposal_tree, is_leaf=is_proposal)
    c_leaves = flatten_up_to(proposal_tree, conditioner, is_proposal)
    return unflatten([_resolve(p, c) for p, c in zip(leaves, c_leaves)])


def value_and_grad_batched(model, params):
    """Per-chain value and gradient over a leading chain axis."""
    if model.logdensity_and_gradient_fn is not None:
        return torch.func.vmap(model.logdensity_and_gradient_fn)(params)
    grad, value = torch.func.vmap(torch.func.grad_and_value(model.logdensity_fn))(params)
    return value, grad


@dataclasses.dataclass(frozen=True)
class MALA(Sampler):
    """≙ ``MALA(d)`` (src/MALA.jl:1-11): a bare callable or distribution is
    wrapped in a ``RandomWalkProposal``; a ``RandomWalkProposal`` is used as
    it is. ``langevin_step_size_sq`` is set by :meth:`langevin` and lets
    ``sample(engine="fused")`` run the sampler on the MALA kernel."""

    proposal: Any
    langevin_step_size_sq: Optional[float] = None

    def __post_init__(self):
        leaves, _ = tree_flatten(self.proposal, is_leaf=is_proposal)
        if not any(is_proposal(leaf) for leaf in leaves):
            object.__setattr__(self, "proposal", RandomWalkProposal(self.proposal))

    @staticmethod
    def langevin(step_size_sq: float) -> "MALA":
        """The canonical Langevin proposal ``MvNormal(σ²/2·g, σ²·I)``."""
        from ..distributions import MvNormal

        s2 = float(step_size_sq)
        sigma = float(np.sqrt(np.float32(s2)))
        return MALA(lambda g: MvNormal(0.5 * s2 * g, scale=sigma),
                    langevin_step_size_sq=s2)

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """≙ src/MALA.jl:37: MALA requires initial parameters."""
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        model = as_model(model)
        check_capabilities(model)
        lp, grad = logdensity_and_gradient(model, initial_params)
        t = GradientTransition(initial_params, lp, grad,
                               torch.zeros((), dtype=torch.bool, device=lp.device))
        return t, t

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...],
                     initial_params=None, init_batched: bool = False):
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        model = as_model(model)
        check_capabilities(model)
        params = initial_params if init_batched else tree_map(
            lambda x: x.expand(batch_shape + tuple(x.shape)).clone(), initial_params)
        lp, grad = value_and_grad_batched(model, params)
        t = GradientTransition(params, lp, grad,
                               torch.zeros(batch_shape, dtype=torch.bool, device=lp.device))
        return t, t

    def _finish(self, gen, state, candidate, lp_c, grad_c, logratio):
        logalpha = lp_c - state.lp + logratio
        accepted = accept_reject(gen, logalpha)
        t = GradientTransition(
            select_tree(accepted, candidate, state.params),
            torch.where(accepted, lp_c, state.lp),
            select_tree(accepted, grad_c, state.gradient),
            accepted,
        )
        return t, t

    def step(self, gen, state: GradientTransition, model):
        """≙ src/MALA.jl:54-93."""
        model = as_model(model)
        prop_state = _resolve_tree(self.proposal, state.gradient)
        candidate = propose(gen, prop_state, state.params)
        lp_c, grad_c = logdensity_and_gradient(model, candidate)
        prop_c = _resolve_tree(self.proposal, grad_c)
        logratio = q(prop_c, state.params, candidate) - q(prop_state, candidate, state.params)
        return self._finish(gen, state, candidate, lp_c, grad_c, logratio)

    def step_batched(self, gen, state: GradientTransition, model,
                     batch_shape: Tuple[int, ...]):
        """One step over a chain batch: functional leaves resolve against the
        batched gradient, one vmapped value-and-gradient pass."""
        model = as_model(model)
        bn = len(batch_shape)
        prop_state = _resolve_tree(self.proposal, state.gradient)
        candidate = propose(gen, self.proposal, state.params, batch_shape,
                            conditioner=state.gradient)
        lp_c, grad_c = value_and_grad_batched(model, candidate)
        prop_c = _resolve_tree(self.proposal, grad_c)
        logratio = (q(prop_c, state.params, candidate, batch_ndim=bn)
                    - q(prop_state, candidate, state.params, batch_ndim=bn))
        return self._finish(gen, state, candidate, lp_c, grad_c, logratio)
