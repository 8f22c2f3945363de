"""Elliptical slice sampling (≙ advancedmh_tpu/samplers/ess.py; Murray, Adams
& MacKay 2010).

The target must factor as ``π(f) ∝ L(f)·N(f; μ, Σ)``: the model's density
is the log-likelihood only, and the Gaussian factor is the sampler's
``prior`` (a Normal / MvNormal leaf, or a tree of them matching the params
tree). One step:

    ν ~ N(μ, Σ) per leaf,  log y = log L(f) − Exponential(1),
    θ ~ U(0, 2π), bracket [θ − 2π, θ],
    repeat: f' = μ + (f − μ)·cos θ + (ν − μ)·sin θ; accept iff log L(f') > log y,
            else shrink the bracket toward 0 and draw θ again,

with no rejections and no tuning parameter. A chain that exhausts
``max_shrink`` trips keeps its state and reports ``accepted=False``.

A step is its draws (:meth:`EllipticalSlice.draws`) then a deterministic move
(:meth:`EllipticalSlice.ess_move`), the masked trip loop of
``ops/ess.py::ess_trips`` over the chain batch, which exits when every chain
has accepted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..distributions import Distribution, MvNormal, Normal
from ..distributions.base import as_param
from ..models.density import as_model, logdensity, logdensity_batched
from ..ops.ess import ess_trips
from ..utils.tree import leaves_to_matrix, matrix_to_leaves, tree_flatten
from .base import Sampler, Transition
from .slice import batch_density

_TWO_PI = 2.0 * math.pi


def _is_dist(x) -> bool:
    return isinstance(x, Distribution)


def flatten_prior(prior):
    """Prior tree → (distribution leaves, unflatten); every leaf must be
    Gaussian."""
    dists, unflatten = tree_flatten(prior, is_leaf=_is_dist)
    for d in dists:
        if not isinstance(d, (Normal, MvNormal)):
            raise TypeError(
                "EllipticalSlice requires a Gaussian prior on every leaf "
                f"(Normal or MvNormal), got {type(d).__name__}. The target "
                "must factor as likelihood × Gaussian prior; pass the "
                "non-Gaussian parts in the model's log density.")
    return dists, unflatten


def base_ndim(d) -> int:
    """Dimensions of one unbatched draw from the Gaussian leaf ``d``."""
    if isinstance(d, MvNormal):
        return d.loc.ndim
    shape = lambda v: tuple(v.shape) if isinstance(v, torch.Tensor) else ()
    return len(torch.broadcast_shapes(shape(d.loc), shape(d.scale)))


def prior_draw(prior, gen, batch_shape=()):
    """Initial params drawn from the prior, one per chain of the batch."""
    dists, unflatten = flatten_prior(prior)
    return unflatten([d.sample(gen, tuple(batch_shape)) for d in dists])


def matched_leaves(prior, params):
    """(prior leaves, params leaves, unflatten); raises when the trees'
    leaf counts differ."""
    dists, _ = flatten_prior(prior)
    leaves, unflatten = tree_flatten(params)
    if len(leaves) != len(dists):
        raise ValueError(
            f"prior has {len(dists)} leaves but params has {len(leaves)} — "
            "the pytrees must match.")
    return dists, leaves, unflatten


def prior_noise(dists, leaves, gen):
    """One prior draw ν per leaf, shaped like the (possibly chain-batched)
    params leaf."""
    return [d.sample(gen, tuple(leaf.shape[: leaf.ndim - base_ndim(d)]))
            for d, leaf in zip(dists, leaves)]


@dataclasses.dataclass(frozen=True)
class EllipticalSlice(Sampler):
    """``EllipticalSlice(prior)``: rejection-free sampler for targets
    likelihood × Gaussian prior. ``max_shrink`` bounds the bracket-shrinkage
    trips of a step."""

    prior: Any
    max_shrink: int = 64

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """Draw the start from the prior unless ``initial_params`` is given
        (≙ the step-init prior draw, reference src/mh-core.jl:76-86)."""
        model = as_model(model)
        flatten_prior(self.prior)
        params = prior_draw(self.prior, gen) if initial_params is None else initial_params
        lp = logdensity(model, params)
        t = Transition(params, lp, torch.zeros((), dtype=torch.bool, device=lp.device))
        return t, t

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
        model = as_model(model)
        flatten_prior(self.prior)
        if initial_params is None:
            params = prior_draw(self.prior, gen, batch_shape)
        elif init_batched:
            params = initial_params
        else:
            leaves, unflatten = tree_flatten(initial_params)
            params = unflatten([x.expand(tuple(batch_shape) + tuple(x.shape)).clone()
                                for x in leaves])
        lp = logdensity_batched(model, params)
        t = Transition(params, lp, torch.zeros(batch_shape, dtype=torch.bool, device=lp.device))
        return t, t

    def draws(self, gen, params, batch_shape):
        """The step's random numbers: ν per leaf, the slice height's
        Exp(1), θ₀ ~ U(0, 2π) and the shrink trips' uniforms."""
        dists, leaves, _ = matched_leaves(self.prior, params)
        nu = prior_noise(dists, leaves, gen)
        dev = gen.device
        e = torch.empty(batch_shape, device=dev).exponential_(generator=gen)
        theta0 = _TWO_PI * torch.rand(batch_shape, generator=gen, device=dev)
        trip_u = torch.rand((self.max_shrink,) + tuple(batch_shape), generator=gen, device=dev)
        return nu, e, theta0, trip_u

    def ess_move(self, model, x, lp, nu, logy, theta0, trip_u, batch_shape=()):
        """The deterministic move from state (``x``, ``lp``) given the prior
        draws ``nu`` (leaves of x's shapes), the slice height ``logy``,
        ``theta0`` and the uniforms ``trip_u`` (max_shrink,) + batch drawn
        after each rejected trip. Returns the Transition; ``accepted`` is the
        done flag."""
        model = as_model(model)
        batch_shape = tuple(batch_shape)
        dists, leaves, unflatten = matched_leaves(self.prior, x)
        mus = [as_param(d.loc, leaf).to(leaf.dtype).expand(leaf.shape)
               for d, leaf in zip(dists, leaves)]
        mu = leaves_to_matrix(mus, batch_shape)
        flat = lambda a: torch.as_tensor(a).reshape(-1)
        res, res_lp, done, _ = ess_trips(
            leaves_to_matrix(leaves, batch_shape), flat(lp),
            leaves_to_matrix(nu, batch_shape) - mu, mu, flat(logy), flat(theta0),
            trip_u.reshape(trip_u.shape[0], -1),
            batch_density(model, unflatten, leaves, batch_shape))
        params = unflatten(matrix_to_leaves(res, leaves, batch_shape))
        return Transition(params, res_lp.reshape(batch_shape), done.reshape(batch_shape))

    def step_batched(self, gen, state: Transition, model, batch_shape: Tuple[int, ...]):
        """One step for the whole chain batch: one shared shrinkage loop,
        each trip one batched likelihood pass."""
        nu, e, theta0, trip_u = self.draws(gen, state.params, batch_shape)
        t = self.ess_move(model, state.params, state.lp, nu, state.lp - e, theta0, trip_u,
                          batch_shape)
        return t, t

    def step(self, gen, state: Transition, model):
        return self.step_batched(gen, state, model, ())
