"""Differential-evolution MCMC (≙ advancedmh_tpu/samplers/demc.py; ter Braak
2006, snooker update ter Braak and Vrugt 2008).

A population of members where each proposal is a scaled difference of two
other members,

    y = x_i + γ·(x_{r1} − x_{r2}) + ε,   ε ~ N(0, noise_scale²·I),

with γ = 2.38/√(2d) by default and, with probability ``jump_probability``
per member-step, γ = 1 mode-jump moves. The optional snooker update (with
probability ``snooker_probability``) moves along the line through x and a
third member z by the projected difference, accepted with the Hastings
factor ‖y − z‖^{d−1}/‖x − z‖^{d−1}.

As the port's emcee, the population splits red-black: each half moves in
parallel against the frozen other half (both difference members from it),
then the halves swap. Given the frozen half the proposal is symmetric, so
plain MH acceptance applies. Parameters may be a tree: moves act leaf by
leaf and the snooker's dots and norms run over all leaves together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..models.density import as_model, logdensity_batched
from ..proposals import as_static_proposal_tree, propose_initial
from ..utils.tree import tree_flatten, tree_map
from .base import Sampler, Transition


def _bcast(s: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return s.reshape(tuple(s.shape) + (1,) * (ref.ndim - s.ndim))


def _tree_dot(a, b) -> torch.Tensor:
    """Per-member dot product over all leaves."""
    la, _ = tree_flatten(a)
    lb, _ = tree_flatten(b)
    return sum(torch.sum((u * v).reshape(u.shape[0], -1), dim=1) for u, v in zip(la, lb))


@dataclasses.dataclass(frozen=True)
class DifferentialEvolution(Sampler):
    """DE-MC population sampler.

    ``payload`` (a Distribution, list of Distributions or a tree of them)
    seeds the members' initial prior draws; ``gamma=None`` takes the
    2.38/√(2d) default. ``n_members`` must be even (red-black halves) and
    ≥ 6, so that each frozen half offers distinct pairs."""

    n_members: int
    payload: Any
    gamma: Optional[float] = None
    noise_scale: float = 1e-4
    jump_probability: float = 0.1
    snooker_probability: float = 0.0
    snooker_gamma: float = 1.683  # 2.38/√2, ter Braak and Vrugt 2008 §2

    is_population = True

    def __post_init__(self):
        if self.n_members % 2 != 0 or self.n_members < 6:
            raise ValueError(f"n_members must be even and ≥ 6, got {self.n_members}")
        if not 0.0 <= self.snooker_probability <= 1.0:
            raise ValueError(
                f"snooker_probability must be in [0, 1], got {self.snooker_probability}")

    @staticmethod
    def _dim_of(params) -> int:
        leaves, _ = tree_flatten(params)
        return int(sum(int(np.prod(leaf.shape[1:])) for leaf in leaves))

    def _gamma(self, d: int) -> float:
        """The DE scale: the given γ, else 2.38/√(2d) in float64."""
        if self.gamma is not None:
            return float(self.gamma)
        return 2.38 / float(np.sqrt(2.0 * d))

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """Each member a static prior draw from the payload, unless
        ``initial_params`` (with a leading member axis) is given."""
        model = as_model(model)
        if initial_params is None:
            params = propose_initial(gen, as_static_proposal_tree(self.payload),
                                     (self.n_members,))
        else:
            params = initial_params
            got = tree_flatten(params)[0][0].shape[0]
            if got != self.n_members:
                raise ValueError(
                    f"initial_params carries {got} members but the sampler was built with "
                    f"n_members={self.n_members}")
        lp = logdensity_batched(model, params)
        t = Transition(params, lp, torch.zeros((self.n_members,), dtype=torch.bool,
                                               device=lp.device))
        return t, t

    def snooker_proposal(self, active, x1, x2, xz, d: int):
        """The snooker proposal y = x + γ_s((x1 − x2)·ê)ê along ê = (x − z)/‖x − z‖
        and its log Hastings term (d−1)/2·(log‖y − z‖² − log‖x − z‖²), −inf
        where x = z or y = z (the move is then rejected)."""
        e = tree_map(lambda xi, zz: xi - zz, active, xz)
        ee = _tree_dot(e, e)
        safe = ee > 1e-30
        coef = self.snooker_gamma * _tree_dot(tree_map(lambda a, b: a - b, x1, x2), e) * \
            torch.where(safe, 1.0 / torch.clamp(ee, min=1e-30), torch.zeros_like(ee))
        y_s = tree_map(lambda xi, ei: xi + _bcast(coef, ei) * ei, active, e)
        ey = tree_map(lambda yy, zz: yy - zz, y_s, xz)
        ee_y = _tree_dot(ey, ey)
        log_j = torch.where(
            safe & (ee_y > 1e-30),
            0.5 * (d - 1) * (torch.log(torch.clamp(ee_y, min=1e-30))
                             - torch.log(torch.clamp(ee, min=1e-30))),
            torch.full_like(ee, -torch.inf))
        return y_s, log_j

    def de_move(self, active, active_lp, other, r1, r2, jump, eps, z_idx, snooker, e, model):
        """The deterministic half-move given its draws: the partner indices
        r1 in [0, H) and r2 in [0, H−1) (bumped past r1 here), the jump flags,
        the noise ``eps`` (a tree like ``active``, already scaled), the
        snooker's z in [0, H−2) (bumped past both here) and flags, and the
        Exp(1) draws ``e`` of the accept test −e < log α. Returns (params, lp,
        accepted) of the moved half."""
        n_active = active_lp.shape[0]
        dev = active_lp.device
        d = self._dim_of(active)
        r2 = r2 + (r2 >= r1).to(r2.dtype)
        x1 = tree_map(lambda p: p[r1], other)
        x2 = tree_map(lambda p: p[r2], other)
        g = torch.where(jump, torch.ones((), device=dev),
                        torch.full((), self._gamma(d), device=dev))
        y = tree_map(lambda xi, a, b, n: xi + _bcast(g, xi) * (a - b) + n, active, x1, x2, eps)
        log_ratio = torch.zeros((n_active,), device=dev)
        if self.snooker_probability > 0.0:
            lo, hi = torch.minimum(r1, r2), torch.maximum(r1, r2)
            z_idx = z_idx + (z_idx >= lo).to(z_idx.dtype)
            z_idx = z_idx + (z_idx >= hi).to(z_idx.dtype)
            y_s, log_j = self.snooker_proposal(active, x1, x2,
                                               tree_map(lambda p: p[z_idx], other), d)
            y = tree_map(lambda ys, yd: torch.where(_bcast(snooker, ys), ys, yd), y_s, y)
            log_ratio = torch.where(snooker, log_j, torch.zeros_like(log_j))
        lp_y = logdensity_batched(model, y)
        accepted = -e < lp_y - active_lp + log_ratio
        new = tree_map(lambda yy, pp: torch.where(_bcast(accepted, yy), yy, pp), y, active)
        return new, torch.where(accepted, lp_y, active_lp), accepted

    def _half_move(self, gen, active, active_lp, other, model):
        """Move one half in parallel against the frozen other half."""
        n = active_lp.shape[0]
        H = tree_flatten(other)[0][0].shape[0]
        dev = active_lp.device
        r1 = torch.randint(0, H, (n,), generator=gen, device=dev)
        r2 = torch.randint(0, H - 1, (n,), generator=gen, device=dev)
        jump = torch.rand((n,), generator=gen, device=dev) < self.jump_probability
        eps = tree_map(lambda leaf: self.noise_scale * torch.randn(
            leaf.shape, generator=gen, device=dev), active)
        z_idx = snooker = None
        if self.snooker_probability > 0.0:
            z_idx = torch.randint(0, H - 2, (n,), generator=gen, device=dev)
            snooker = torch.rand((n,), generator=gen, device=dev) < self.snooker_probability
        e = torch.empty((n,), device=dev).exponential_(generator=gen)
        return self.de_move(active, active_lp, other, r1, r2, jump, eps, z_idx, snooker, e,
                            model)

    def step(self, gen, state: Transition, model):
        """One population update: the two complementary half-moves."""
        model = as_model(model)
        h = self.n_members // 2
        pA = tree_map(lambda x: x[:h], state.params)
        pB = tree_map(lambda x: x[h:], state.params)
        pA, lpA, accA = self._half_move(gen, pA, state.lp[:h], pB, model)
        pB, lpB, accB = self._half_move(gen, pB, state.lp[h:], pA, model)
        t = Transition(tree_map(lambda a, b: torch.cat([a, b]), pA, pB),
                       torch.cat([lpA, lpB]), torch.cat([accA, accB]))
        return t, t
