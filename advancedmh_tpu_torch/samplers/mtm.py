"""Multiple-Try Metropolis (≙ advancedmh_tpu/samplers/mtm.py; Liu, Liang and
Wong 2000).

Each step draws ``k`` candidates around the current state, evaluates their
densities in one batched call, selects one with probability proportional to
its density (Gumbel-argmax), draws k − 1 references around the winner and
accepts with the multiple-try ratio

    log α = logsumexp(lp(y₁..y_k)) − logsumexp(lp(x*₁..x*_{k−1}), lp(x)).

This is the symmetric-weight form w(x, y) = π(y), so the proposal must be
symmetric (checked when the sampler is built). With ``k = 1`` a step is the
MH step, draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..models.density import as_model, logdensity_batched
from ..proposals import RandomWalkProposal, is_proposal, propose
from ..utils.tree import tree_flatten, tree_map
from .base import Transition, accept_reject, select_tree
from .mh import MetropolisHastings, _provably_symmetric_increment


def _check_symmetric(proposals) -> None:
    leaves, _ = tree_flatten(proposals, is_leaf=is_proposal)
    for p in leaves:
        if not is_proposal(p):
            raise ValueError(
                f"MultipleTryMetropolis proposal tree contains a non-proposal "
                f"leaf of type {type(p).__name__}"
            )
        if p.symmetric:
            continue
        if isinstance(p, RandomWalkProposal) and _provably_symmetric_increment(p.payload):
            continue
        raise ValueError(
            "MultipleTryMetropolis uses the symmetric-weight form w(x, y) = "
            "π(y) and therefore requires a symmetric proposal; wrap the "
            "payload in SymmetricRandomWalkProposal (or use a zero-mean "
            "Gaussian random walk)."
        )


def _lp_leading(model, tree, lead_ndim: int) -> torch.Tensor:
    """Log density over ``lead_ndim`` leading batch axes: flattened into the
    one chain axis the model's batched density takes, then restored."""
    if lead_ndim == 1:
        return logdensity_batched(model, tree)
    leaves, _ = tree_flatten(tree)
    lead = tuple(leaves[0].shape[:lead_ndim])
    flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[lead_ndim:])), tree)
    return logdensity_batched(model, flat).reshape(lead)


def _take(leaf: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """Entry ``J`` (per chain) of the leading try axis of ``leaf``."""
    idx = J.reshape((1,) + tuple(J.shape) + (1,) * (leaf.ndim - 1 - J.ndim))
    idx = idx.expand((1,) + tuple(leaf.shape[1:]))
    return torch.gather(leaf, 0, idx)[0]


@dataclasses.dataclass(frozen=True)
class MultipleTryMetropolis(MetropolisHastings):
    """MTM(proposal, k): k-candidate Metropolis-Hastings.

    ``proposal`` is a symmetric :class:`Proposal` leaf or tree of them;
    ``k`` is the number of candidates a step, which costs 2k − 1 density
    evaluations. Initialization is MetropolisHastings'. ``sample(...,
    engine="fused")`` runs it on csrc/mtm.cu for one zero-mean Gaussian
    random-walk leaf."""

    k: int = 4

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        _check_symmetric(self.proposal)

    def _mtm_core(self, gen, state: Transition, model, batch_shape: Tuple[int, ...]):
        """One MTM step over ``batch_shape`` chains (may be ``()``); the try
        axes lead, so a leaf of the candidates is (k,) + batch + event."""
        k = int(self.k)
        bn = len(batch_shape)
        candidates = propose(gen, self.proposal, state.params, (k,) + tuple(batch_shape))
        lps = _lp_leading(model, candidates, 1 + bn)  # (k,) + batch_shape
        if k == 1:
            # the reference set is {x}: the MH step, with no Gumbel draw
            y = tree_map(lambda c: c[0], candidates)
            lp_y = lps[0]
            logalpha = lp_y - state.lp
        else:
            u = torch.rand(lps.shape, generator=gen, device=lps.device)
            u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
            J = torch.argmax(lps + -torch.log(-torch.log(u)), dim=0)
            y = tree_map(lambda c: _take(c, J), candidates)
            lp_y = _take(lps, J)
            refs = propose(gen, self.proposal, y, (k - 1,) + tuple(batch_shape))
            ref_lps = _lp_leading(model, refs, 1 + bn)
            denom = torch.cat([ref_lps, state.lp[None]], dim=0)
            logalpha = torch.logsumexp(lps, dim=0) - torch.logsumexp(denom, dim=0)
        accepted = accept_reject(gen, logalpha)
        t = Transition(select_tree(accepted, y, state.params),
                       torch.where(accepted, lp_y, state.lp), accepted)
        return t, t

    def step(self, gen, state: Transition, model):
        return self._mtm_core(gen, state, as_model(model), ())

    def step_batched(self, gen, state: Transition, model, batch_shape: Tuple[int, ...]):
        """Vectorized over the chain batch: the density sees one
        ``k·chains`` batch per phase."""
        return self._mtm_core(gen, state, as_model(model), tuple(batch_shape))
