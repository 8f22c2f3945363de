"""Hamiltonian Monte Carlo (≙ advancedmh_tpu/samplers/hmc.py).

``n_leapfrog`` leapfrog steps of size ``step_size``, then the exact MH test
on the total-energy error (Neal 2011 §5.2). Params may be any tree; the
momentum has the same structure. A diagonal ``inverse_mass`` tree (matching
the params, or broadcastable leaves) preconditions the dynamics: the drift
uses ``M⁻¹·p``, the kinetic energy is ``½·pᵀM⁻¹p``, momenta are N(0, M).

``trajectory_sampling="multinomial"`` samples one state of the whole
(L+1)-state orbit with weights ∝ exp(lp − K) instead of the endpoint accept
(uniform trajectory offset, streamed Gumbel-argmax; Neal 1994 §4).

The step size may be a per-chain tensor (``StepSizeAdaptation.hmc``,
``AdaptiveHMC``): it broadcasts against each leaf's event dimensions.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, check_capabilities, logdensity_and_gradient
from ..utils.tree import tree_flatten, tree_map
from .base import GradientTransition, Sampler, select_tree
from .mala import value_and_grad_batched


def _tree_sum(tree) -> torch.Tensor:
    leaves, _ = tree_flatten(tree)
    total = leaves[0]
    for leaf in leaves[1:]:
        total = total + leaf
    return total


@dataclasses.dataclass(frozen=True)
class HamiltonianMC(Sampler):
    """Fixed-trajectory HMC: ``n_leapfrog`` leapfrog steps of size
    ``step_size``, exact MH accept on the energy error.

    ``inverse_mass``: optional tree (matching params, or broadcastable
    leaves) of diagonal inverse-mass entries; ``None`` = identity."""

    step_size: Any
    n_leapfrog: int = 10
    inverse_mass: Optional[Any] = None
    trajectory_sampling: str = "endpoint"

    def __post_init__(self):
        # step_size may be a per-chain tensor under the adaptive samplers;
        # only plain numbers are validated
        if isinstance(self.step_size, (int, float)) and self.step_size <= 0.0:
            raise ValueError("step_size must be positive")
        if int(self.n_leapfrog) < 1:
            raise ValueError("n_leapfrog must be >= 1")
        if self.trajectory_sampling not in ("endpoint", "multinomial"):
            raise ValueError("trajectory_sampling must be 'endpoint' or 'multinomial'")

    # -- physics -----------------------------------------------------------

    def _minv(self, params):
        if self.inverse_mass is None:
            return tree_map(torch.ones_like, params)
        return tree_map(
            lambda x, m: torch.as_tensor(m, dtype=x.dtype).to(x.device).broadcast_to(x.shape),
            params, self.inverse_mass,
        )

    def _eps(self, device) -> torch.Tensor:
        return torch.as_tensor(self.step_size, dtype=torch.float32).to(device)

    @staticmethod
    def _e_for(eps: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
        """A per-chain step size broadcast over a leaf's event dims."""
        if eps.ndim == 0 or eps.ndim == leaf.ndim:
            return eps
        return eps.reshape(eps.shape + (1,) * (leaf.ndim - eps.ndim))

    def _momentum(self, z, params):
        """p = z/√M⁻¹ ~ N(0, M) from standard normals ``z``."""
        return tree_map(lambda zz, m: zz / torch.sqrt(m), z, self._minv(params))

    def _kinetic(self, p, params, bn: int = 0):
        """½·pᵀM⁻¹p, reduced over all but the first ``bn`` (batch) axes."""

        def part(pp, m):
            k = pp * pp * m * 0.5
            # torch.sum over dim=() would reduce every axis: a leaf with no
            # event axes (one scalar per chain) is its own sum
            return k if k.ndim == bn else torch.sum(k, dim=tuple(range(bn, k.ndim)))

        return _tree_sum(tree_map(part, p, self._minv(params)))

    def _trajectory(self, vg, x, p, lp, grad):
        """``n_leapfrog`` kick-drift-kick steps; returns (x, p, lp, grad)."""
        eps = self._eps(lp.device)
        minv = self._minv(x)
        for _ in range(int(self.n_leapfrog)):
            x, p, lp, grad = self._leap(vg, x, p, grad, eps, minv)
        return x, p, lp, grad

    def _leap(self, vg, x, p, grad, eps, minv, sign=1.0):
        e = self._e_for
        p = tree_map(lambda pp, g: pp + sign * 0.5 * e(eps, pp) * g, p, grad)
        x = tree_map(lambda xx, pp, m: xx + sign * e(eps, xx) * m * pp, x, p, minv)
        lp, grad = vg(x)
        p = tree_map(lambda pp, g: pp + sign * 0.5 * e(eps, pp) * g, p, grad)
        return x, p, lp, grad

    def _draw_normals(self, gen, params):
        return tree_map(lambda x: torch.randn(x.shape, generator=gen, device=gen.device), params)

    # -- multinomial trajectory sampling ------------------------------------

    def _step_multinomial(self, gen, state: GradientTransition, model, batch_shape):
        """Uniform-offset multinomial trajectory sampling (rejection-free):
        a shared offset j ~ U{0..L} places the current state in an
        (L+1)-state orbit; j leapfrog steps run backward and L−j forward,
        restarting from the origin at trip j, and one state is kept by a
        streaming Gumbel-argmax over lp − K."""
        model = as_model(model)
        bn = len(batch_shape)
        vg = self._vg(model, bn)
        eps = self._eps(state.lp.device)
        minv = self._minv(state.params)
        L = int(self.n_leapfrog)
        p0 = self._momentum(self._draw_normals(gen, state.params), state.params)
        j = int(torch.randint(0, L + 1, (), generator=gen, device=gen.device))
        u = torch.rand((L + 1,) + tuple(batch_shape), generator=gen, device=gen.device)
        gums = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))

        def sel(mask, c, prev):
            return torch.where(mask.reshape(mask.shape + (1,) * (c.ndim - bn)), c, prev)

        best_score = state.lp - self._kinetic(p0, state.params, bn) + gums[0]
        bx, blp, bgrad = state.params, state.lp, state.gradient
        moved = torch.zeros(batch_shape, dtype=torch.bool, device=state.lp.device)
        x, p, lp, grad = state.params, p0, state.lp, state.gradient
        for i in range(L):
            if i == j:  # the forward segment restarts from the origin
                x, p, lp, grad = state.params, p0, state.lp, state.gradient
            x, p, lp, grad = self._leap(vg, x, p, grad, eps, minv, -1.0 if i < j else 1.0)
            score = lp - self._kinetic(p, x, bn) + gums[i + 1]
            upd = score > best_score
            best_score = torch.where(upd, score, best_score)
            bx = tree_map(lambda c, q: sel(upd, c, q), x, bx)
            blp = torch.where(upd, lp, blp)
            bgrad = tree_map(lambda c, q: sel(upd, c, q), grad, bgrad)
            moved = moved | upd
        t = GradientTransition(bx, blp, bgrad, moved)
        return t, t

    # -- kernel ------------------------------------------------------------

    @staticmethod
    def _vg(model, bn: int):
        if bn == 0:
            return lambda x: logdensity_and_gradient(model, x)
        return lambda x: value_and_grad_batched(model, x)

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """HMC requires initial parameters and an order-≥1 model."""
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
            lambda x: x.expand(tuple(batch_shape) + tuple(x.shape)).clone(), initial_params)
        lp, grad = value_and_grad_batched(model, params)
        t = GradientTransition(params, lp, grad,
                               torch.zeros(batch_shape, dtype=torch.bool, device=lp.device))
        return t, t

    def step_from_noise(self, state: GradientTransition, model, z, e,
                        batch_shape: Tuple[int, ...] = ()):
        """One endpoint step from given noise: standard normals ``z`` (the
        params' structure) for the momentum and Exp(1) draws ``e`` for the
        accept test ``-e < logα``."""
        model = as_model(model)
        bn = len(batch_shape)
        p0 = self._momentum(z, state.params)
        x1, p1, lp1, grad1 = self._trajectory(self._vg(model, bn), state.params, p0,
                                              state.lp, state.gradient)
        # ΔH = (lp' − K') − (lp − K): the negated total-energy error
        logalpha = ((lp1 - self._kinetic(p1, x1, bn))
                    - (state.lp - self._kinetic(p0, state.params, bn)))
        accepted = -e < logalpha
        t = GradientTransition(select_tree(accepted, x1, state.params),
                               torch.where(accepted, lp1, state.lp),
                               select_tree(accepted, grad1, state.gradient), accepted)
        return t, t

    def step(self, gen, state: GradientTransition, model):
        if self.trajectory_sampling == "multinomial":
            return self._step_multinomial(gen, state, model, ())
        z = self._draw_normals(gen, state.params)
        e = torch.empty((), device=gen.device).exponential_(generator=gen)
        return self.step_from_noise(state, model, z, e)

    def step_batched(self, gen, state: GradientTransition, model,
                     batch_shape: Tuple[int, ...]):
        """One step over a chain batch: one batched value-and-gradient per
        leapfrog step."""
        if self.trajectory_sampling == "multinomial":
            return self._step_multinomial(gen, state, model, batch_shape)
        z = self._draw_normals(gen, state.params)
        e = torch.empty(batch_shape, device=gen.device).exponential_(generator=gen)
        return self.step_from_noise(state, model, z, e, batch_shape)

