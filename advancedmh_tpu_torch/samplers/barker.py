"""Barker proposal MCMC (≙ advancedmh_tpu/samplers/barker.py; Livingstone &
Zanella 2022).

Per coordinate z ~ N(0, σ²) is applied with a gradient-informed sign,

    b = +1 with probability sigmoid(z·∂ᵢ log π(x)), −1 otherwise;  y = x + b·z,

and accepted with the coordinatewise softplus Hastings correction

    log α = Δlog π + Σᵢ [softplus(−δᵢ·gᵢ(x)) − softplus(δᵢ·gᵢ(y))],

δ = y − x. The skew is bounded, so the sampler keeps a random walk's
robustness to large σ with gradient guidance. The gradient is cached in the
``GradientTransition``: one value-and-gradient evaluation per step. Params
may be any tree: every operation is per element, and the Hastings sum runs
over every leaf element. softplus is ``logaddexp(t, 0)``, the form of
``jax.nn.softplus``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, check_capabilities, logdensity_and_gradient
from ..utils.tree import tree_flatten, tree_map
from .base import GradientTransition, Sampler, select_tree
from .mala import value_and_grad_batched


def _softplus(t: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(t, torch.zeros_like(t))


@dataclasses.dataclass(frozen=True)
class Barker(Sampler):
    """``Barker(step_size)``: σ is the per-coordinate proposal scale (a
    number, or per-chain ``(C, 1)`` under ``StepSizeAdaptation.barker``).
    Its optimal acceptance is ≈ 0.57."""

    step_size: Any = 1.0

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """Requires initial parameters and a gradient-capable model (≙
        src/MALA.jl:37)."""
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        model = as_model(model)
        check_capabilities(model)
        lp, grad = logdensity_and_gradient(model, initial_params)
        t = GradientTransition(initial_params, lp, grad,
                               torch.zeros((), dtype=torch.bool, device=lp.device))
        return t, t

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
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

    def _propose(self, z, u, gradient):
        """Gradient-skewed increments δ from standard normals ``z`` and
        uniforms ``u`` (trees of the params' shapes)."""
        def leaf(zl, ul, gl):
            zs = self.step_size * zl
            return torch.where(ul < torch.sigmoid(zs * gl), zs, -zs)

        return tree_map(leaf, z, u, gradient)

    def draws(self, gen, params, batch_shape):
        """The step's random numbers: per leaf normals, per leaf uniforms
        (trees of the params' shapes), then the accept test's Exp(1)."""
        leaves, unflatten = tree_flatten(params)
        dev = gen.device
        z = unflatten([torch.randn(tuple(x.shape), generator=gen, device=dev) for x in leaves])
        u = unflatten([torch.rand(tuple(x.shape), generator=gen, device=dev) for x in leaves])
        e = torch.empty(tuple(batch_shape), device=dev).exponential_(generator=gen)
        return z, u, e

    @staticmethod
    def _logratio(delta, grad_x, grad_y, batch_ndim: int = 0):
        """Σ softplus(−δ·g(x)) − softplus(δ·g(y)) over all leaf elements."""
        terms = tree_map(lambda d, gx, gy: _softplus(-d * gx) - _softplus(d * gy),
                         delta, grad_x, grad_y)
        leaves, _ = tree_flatten(terms)
        return sum(torch.sum(t.reshape(t.shape[:batch_ndim] + (-1,)), dim=-1) for t in leaves)

    def step_from_noise(self, state: GradientTransition, model, batch_shape, z, u, e):
        """One step from the normals ``z`` and uniforms ``u`` (trees of the
        params' shapes) and the accept test's Exp(1) draws ``e``: one
        (batched) value-and-gradient pass, accepted iff −e < log α."""
        model = as_model(model)
        delta = self._propose(z, u, state.gradient)
        candidate = tree_map(torch.add, state.params, delta)
        if batch_shape:
            lp_c, grad_c = value_and_grad_batched(model, candidate)
        else:
            lp_c, grad_c = logdensity_and_gradient(model, candidate)
        logalpha = lp_c - state.lp + self._logratio(delta, state.gradient, grad_c,
                                                    len(batch_shape))
        accepted = -e < logalpha
        t = GradientTransition(select_tree(accepted, candidate, state.params),
                               torch.where(accepted, lp_c, state.lp),
                               select_tree(accepted, grad_c, state.gradient), accepted)
        return t, t

    def step_batched(self, gen, state: GradientTransition, model, batch_shape: Tuple[int, ...]):
        z, u, e = self.draws(gen, state.params, batch_shape)
        return self.step_from_noise(state, model, batch_shape, z, u, e)

    def step(self, gen, state: GradientTransition, model):
        return self.step_batched(gen, state, model, ())
