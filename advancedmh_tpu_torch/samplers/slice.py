"""Slice sampling (≙ advancedmh_tpu/samplers/slice.py; Neal 2003, Annals of
Statistics §4-5).

Slices the whole target density along a random unit direction u (one unit
vector over the whole params tree):

    log y = log π(x) − Exponential(1)
    [L, R] = [−w·U₀, w·(1 − U₀)], stepped out with Neal's budget m split
             J = ⌊m·V⌋ left, K = m − 1 − J right (Fig. 3)
    shrink: t ~ U(L, R); accept x + t·u iff log π > log y, else the rejected
            t becomes the bracket end on its own side of 0 (Fig. 5)

Every step ends in the slice, up to the ``max_shrink`` bound: a chain that
exhausts it keeps its state and reports ``accepted=False``.

A step is its draws (:meth:`SliceSampler.draws`) then a deterministic move
(:meth:`SliceSampler.slice_move`), the loops of ``ops/slice.py::slice_trips``
over the chain batch: stepping out as a masked loop of ``max_stepout − 1``
trips, shrinkage as a masked loop that exits when every chain is done.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model, logdensity, logdensity_batched
from ..ops.slice import slice_trips, unit_direction
from ..utils.tree import leaves_to_matrix, matrix_to_leaves, tree_flatten, tree_map
from .base import Sampler, Transition


def batch_density(model, unflatten, like, batch_shape):
    """The model's density at points given as a (B, D) matrix
    (utils/tree.py::leaves_to_matrix of leaves shaped as ``like``), as (B,)."""
    if len(batch_shape) > 1:
        raise ValueError("slice samplers take one chain or one batch axis")

    def ld(mat):
        params = unflatten(matrix_to_leaves(mat, like, batch_shape))
        lp = logdensity_batched(model, params) if batch_shape else logdensity(model, params)
        return lp.reshape(-1)

    return ld


@dataclasses.dataclass(frozen=True)
class SliceSampler(Sampler):
    """``SliceSampler(width)``: random-direction slice sampling.

    ``width`` is the stepping-out unit w; ``max_stepout`` Neal's interval
    budget m (the bracket grows to at most m·w); ``max_shrink`` the bound on
    shrinkage trips."""

    width: float = 1.0
    max_stepout: int = 8
    max_shrink: int = 32

    def init(self, gen, model, initial_params: Optional[Any] = None):
        """Requires initial parameters (≙ MALA, src/MALA.jl:37)."""
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        model = as_model(model)
        lp = logdensity(model, initial_params)
        t = Transition(initial_params, lp, torch.zeros((), dtype=torch.bool, device=lp.device))
        return t, t

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        model = as_model(model)
        params = initial_params if init_batched else tree_map(
            lambda x: x.expand(tuple(batch_shape) + tuple(x.shape)).clone(), initial_params)
        lp = logdensity_batched(model, params)
        t = Transition(params, lp, torch.zeros(batch_shape, dtype=torch.bool, device=lp.device))
        return t, t

    def draws(self, gen, params, batch_shape):
        """The step's random numbers: normals per leaf (the direction), the
        slice height's Exp(1), U₀, V and the shrink trips' uniforms."""
        leaves, _ = tree_flatten(params)
        dev = gen.device
        z = [torch.randn(tuple(leaf.shape), generator=gen, device=dev) for leaf in leaves]
        e = torch.empty(batch_shape, device=dev).exponential_(generator=gen)
        u0 = torch.rand(batch_shape, generator=gen, device=dev)
        v = torch.rand(batch_shape, generator=gen, device=dev)
        trip_u = torch.rand((self.max_shrink,) + tuple(batch_shape), generator=gen, device=dev)
        return z, e, u0, v, trip_u

    def slice_move(self, model, x, lp, z, logy, u0, v, trip_u, batch_shape=()):
        """The deterministic move from state (``x``, ``lp``) given the
        direction's normals ``z`` (leaves of x's shapes), the slice height
        ``logy``, ``u0``, ``v`` and the trips' uniforms ``trip_u``
        (max_shrink,) + batch. Returns the Transition; ``accepted`` is the
        done flag."""
        model = as_model(model)
        batch_shape = tuple(batch_shape)
        leaves, unflatten = tree_flatten(x)
        flat = lambda a: torch.as_tensor(a).reshape(-1)
        res, res_lp, done, _ = slice_trips(
            leaves_to_matrix(leaves, batch_shape), flat(lp),
            unit_direction(leaves_to_matrix(z, batch_shape)), flat(logy), flat(u0),
            flat(v), trip_u.reshape(trip_u.shape[0], -1),
            batch_density(model, unflatten, leaves, batch_shape), self.width, self.max_stepout)
        params = unflatten(matrix_to_leaves(res, leaves, batch_shape))
        return Transition(params, res_lp.reshape(batch_shape), done.reshape(batch_shape))

    def step_batched(self, gen, state: Transition, model, batch_shape: Tuple[int, ...]):
        """One step for the whole chain batch: one shared stepping-out and
        shrinkage loop, each trip one batched density pass."""
        z, e, u0, v, trip_u = self.draws(gen, state.params, batch_shape)
        t = self.slice_move(model, state.params, state.lp, z, state.lp - e, u0, v, trip_u,
                            batch_shape)
        return t, t

    def step(self, gen, state: Transition, model):
        return self.step_batched(gen, state, model, ())
