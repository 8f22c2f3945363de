"""Composable proposal algebra over parameter trees.

≙ advancedmh_tpu/proposals/core.py (reference src/proposal.jl:1-240).

- A **proposal** is a :class:`Proposal` leaf or a dict / tuple / list tree of
  them; samples come back in the shape of the proposal.
- Leaf payloads are a :class:`Distribution`, a list/tuple of distributions
  (elementwise sample, summed log_prob), or a callable returning a
  distribution (state-dependent proposals).
- ``symmetric`` is a plain Python bool known when the sampler is built: a
  symmetric leaf contributes nothing to the Hastings term and its density is
  never evaluated, and an all-symmetric tree gives the Python float ``0.0``.

Every draw takes an explicit ``torch.Generator``; leaves draw from it in
tree order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Union

import torch

from ..distributions import Distribution
from ..utils.tree import flatten_up_to, tree_flatten, tree_map

PayloadT = Union[Distribution, Sequence[Distribution], Callable]


class Proposal:
    """Abstract proposal leaf (≙ ``Proposal{P}``, src/proposal.jl:1)."""

    payload: PayloadT
    symmetric: bool


@dataclasses.dataclass(frozen=True)
class StaticProposal(Proposal):
    """Independence proposal: candidates drawn ignoring the current state
    (≙ ``StaticProposal``, src/proposal.jl:3-11)."""

    payload: PayloadT
    symmetric: bool = False


@dataclasses.dataclass(frozen=True)
class RandomWalkProposal(Proposal):
    """Random-walk proposal: candidate = state + draw(payload)
    (≙ ``RandomWalkProposal``, src/proposal.jl:13-21)."""

    payload: PayloadT
    symmetric: bool = False


def SymmetricStaticProposal(payload) -> StaticProposal:
    """≙ ``SymmetricStaticProposal`` alias (src/proposal.jl:6)."""
    return StaticProposal(payload, symmetric=True)


def SymmetricRandomWalkProposal(payload) -> RandomWalkProposal:
    """≙ ``SymmetricRandomWalkProposal`` alias (src/proposal.jl:16)."""
    return RandomWalkProposal(payload, symmetric=True)


def is_proposal(x: Any) -> bool:
    return isinstance(x, Proposal)


def _is_dist_seq(payload) -> bool:
    return isinstance(payload, (list, tuple)) and all(
        isinstance(p, Distribution) for p in payload
    )


def _payload_sample(gen, payload, batch_shape: tuple = ()) -> torch.Tensor:
    """Draw from a payload, with ``batch_shape`` iid draws prepended."""
    if isinstance(payload, Distribution):
        return payload.sample(gen, batch_shape)
    if _is_dist_seq(payload):
        return torch.stack(
            [d.sample(gen, batch_shape) for d in payload], dim=len(batch_shape)
        )
    raise TypeError(
        f"Cannot sample from proposal payload of type {type(payload).__name__}; "
        "expected a Distribution, a sequence of Distributions, or a callable "
        "returning one."
    )


def _payload_sample_prebatched(gen, payload) -> torch.Tensor:
    """Draw from a payload whose parameters already carry the batch axis."""
    if isinstance(payload, Distribution):
        return payload.sample(gen)
    if _is_dist_seq(payload):
        return torch.stack([d.sample(gen) for d in payload], dim=-1)
    raise TypeError(
        f"Cannot sample from proposal payload of type {type(payload).__name__}."
    )


def _payload_logprob(payload, v, batch_ndim: int = 0) -> torch.Tensor:
    """Proposal log-density summed over event dims, keeping the leading
    ``batch_ndim`` axes."""

    def _reduce(lp):
        dims = tuple(range(batch_ndim, lp.ndim))
        return torch.sum(lp, dim=dims) if dims else lp

    if isinstance(payload, Distribution):
        return _reduce(payload.log_prob(v))
    if _is_dist_seq(payload):
        idx = (slice(None),) * batch_ndim
        return sum(
            _reduce(d.log_prob(v[idx + (i,)])) for i, d in enumerate(payload)
        )
    raise TypeError(
        f"Cannot evaluate log_prob of proposal payload {type(payload).__name__}."
    )


def _resolve(proposal: Proposal, t=None) -> Proposal:
    """Resolve a functional payload against the conditioning state
    (``p()`` at init, ``p(t)`` after; src/proposal.jl:92-126)."""
    payload = proposal.payload
    if callable(payload) and not isinstance(payload, Distribution):
        resolved = payload() if t is None else payload(t)
        if isinstance(resolved, Proposal):
            return resolved
        return type(proposal)(resolved, symmetric=proposal.symmetric)
    return proposal


def _leaf_is_functional(p: Proposal) -> bool:
    return callable(p.payload) and not isinstance(p.payload, Distribution)


def as_static_proposal_tree(payload):
    """Wrap each distribution (or distribution sequence, or callable) leaf
    of a payload tree in a StaticProposal; the ensemble sampler draws its
    initial walkers from it."""

    def is_leaf(x):
        return isinstance(x, Distribution) or _is_dist_seq(x) or callable(x)

    return tree_map(StaticProposal, payload, is_leaf=is_leaf)


def propose_initial(gen, proposals, batch_shape: tuple = ()):
    """Initial draw: sample each leaf's payload directly
    (src/mh-core.jl:76-86 via src/proposal.jl:41-47)."""
    return tree_map(
        lambda p: _payload_sample(gen, _resolve(p, None).payload, batch_shape),
        proposals,
        is_leaf=is_proposal,
    )


def propose(gen, proposals, params, batch_shape: tuple = (), conditioner=None):
    """Propose a candidate conditioned on the current ``params`` tree
    (src/proposal.jl:49-56, :70-85, :104-126, :132-175).

    With ``batch_shape`` the params leaves carry a leading chain batch:
    fixed payloads draw ``batch_shape`` iid samples, functional payloads
    resolve against the batched conditioner and draw once.
    """
    if conditioner is None:
        conditioner = params

    def draw(p, t, c):
        functional = _leaf_is_functional(p)
        p = _resolve(p, c)
        if functional and batch_shape:
            x = _payload_sample_prebatched(gen, p.payload)
        else:
            x = _payload_sample(gen, p.payload, batch_shape)
        return t + x if isinstance(p, RandomWalkProposal) else x

    return tree_map(draw, proposals, params, conditioner, is_leaf=is_proposal)


def q(proposals, t, t_cond, batch_ndim: int = 0):
    """Proposal log-density ``log g(t | t_cond)`` summed over the tree
    (src/proposal.jl:58-64)."""
    leaves, _ = tree_flatten(proposals, is_leaf=is_proposal)
    t_leaves = flatten_up_to(proposals, t, is_proposal)
    tc_leaves = flatten_up_to(proposals, t_cond, is_proposal)
    total = 0.0
    for p, tl, tcl in zip(leaves, t_leaves, tc_leaves):
        p = _resolve(p, tcl)
        v = tl - tcl if isinstance(p, RandomWalkProposal) else tl
        total = total + _payload_logprob(p.payload, v, batch_ndim)
    return total


def logratio_proposal_density(proposals, state, candidate, batch_ndim: int = 0):
    """Hastings correction ``log g(state|candidate) − log g(candidate|state)``
    (src/proposal.jl:190-240). Symmetric leaves are skipped; an
    all-symmetric tree returns the Python float ``0.0``."""
    leaves, _ = tree_flatten(proposals, is_leaf=is_proposal)
    s_leaves = flatten_up_to(proposals, state, is_proposal)
    c_leaves = flatten_up_to(proposals, candidate, is_proposal)
    total = 0.0
    for p, sl, cl in zip(leaves, s_leaves, c_leaves):
        if p.symmetric:
            continue
        p_fwd = _resolve(p, sl)  # g(candidate | state)
        p_bwd = _resolve(p, cl)  # g(state | candidate)
        if isinstance(p, RandomWalkProposal):
            total = (
                total
                + _payload_logprob(p_bwd.payload, sl - cl, batch_ndim)
                - _payload_logprob(p_fwd.payload, cl - sl, batch_ndim)
            )
        else:
            total = (
                total
                + _payload_logprob(p_bwd.payload, sl, batch_ndim)
                - _payload_logprob(p_fwd.payload, cl, batch_ndim)
            )
    return total
