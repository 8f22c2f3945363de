"""Replica exchange (parallel tempering) around an inner sampler
(≙ advancedmh_tpu/samplers/tempering.py).

K tempered replicas of the inner sampler run per chain, targeting
β_k·logdensity with β₀ = 1 the cold chain, and adjacent replicas propose a
swap after every inner step with ``log α = (β_k − β_{k+1})(ℓ_{k+1} − ℓ_k)``
on the raw log densities ℓ = lp/β.

The replicas are a leading axis of a chain's state: a one-chain state has
leaves (K, ...), the runtime's chain batch gives (C, K, ...). The inner step
takes the place of JAX's ``vmap`` over (keys, inner, betas): one batched
step of the inner sampler over the (chains, K) batch on a tempered model
whose batched density multiplies the model's by β (K,) along the replica
axis. The even-odd swap sweep is two vectorized half-exchanges; a swap
re-tempers the moved lp (and a MALA inner's cached gradient) to the
receiving replica's β.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..distributions import MvNormal, Normal
from ..models.density import DensityModel, as_model, logdensity_batched
from ..proposals import RandomWalkProposal
from ..utils.tree import tree_flatten, tree_map
from .base import Sampler


@dataclasses.dataclass(frozen=True)
class ReplicaExchangeState:
    """Stacked inner states (replica axis K after the chain axes) and the
    swap statistics (..., K−1). ``raw_lp`` is the untempered ℓ (..., K)
    that the fused engine carries so that a resumed run continues from the
    exact values; None from the torch engine (a resume then recomputes ℓ)."""

    inner: Any
    swap_accept_count: torch.Tensor
    swap_proposal_count: torch.Tensor
    raw_lp: Optional[torch.Tensor] = None


def _tempered_model(model: DensityModel, betas: torch.Tensor) -> DensityModel:
    """The model tempered per replica, for states whose leaves are
    (B, K, ...): the batched density flattens (B, K), evaluates the model's
    batched density and multiplies by β (K,); the per-chain value and
    gradient (leaves (K, ...), as a vmap over B sees them) do the same with
    the model's per-point value and gradient."""
    from .mala import value_and_grad_batched

    def batched(x):
        leaves, _ = tree_flatten(x)
        lead = tuple(leaves[0].shape[:2])
        flat = tree_map(lambda v: v.reshape((-1,) + tuple(v.shape[2:])), x)
        return logdensity_batched(model, flat).reshape(lead) * betas

    def per_chain(x):
        return logdensity_batched(model, x) * betas

    def value_and_grad(x):
        lp, g = value_and_grad_batched(model, x)
        return lp * betas, tree_map(
            lambda v: v * betas.reshape((-1,) + (1,) * (v.ndim - 1)), g)

    return DensityModel(logdensity_fn=per_chain, logdensity_and_gradient_fn=value_and_grad,
                        dimension=model.dimension, capabilities=model.capabilities,
                        logdensity_batched_fn=batched, device=model.device)


def _map_fields(fn, state, *rest):
    """``fn`` over every leaf of every field of an inner state (a
    Transition-shaped dataclass), with the matching leaves of ``rest``."""
    return type(state)(*[
        tree_map(fn, getattr(state, f.name), *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(state)])


def _lead(state: ReplicaExchangeState) -> int:
    """Chain axes before the replica axis (0 for one chain, 1 batched)."""
    return state.swap_accept_count.ndim - 1


def _gather_replicas(v: torch.Tensor, perm: torch.Tensor, lead: int) -> torch.Tensor:
    """``v`` (lead..., K, ...) with its replica axis permuted per chain by
    ``perm`` (lead..., K)."""
    idx = perm.reshape(tuple(perm.shape) + (1,) * (v.ndim - perm.ndim)).expand(v.shape)
    return torch.gather(v, lead, idx)


@dataclasses.dataclass(frozen=True)
class ReplicaExchange(Sampler):
    """Parallel tempering around any inner :class:`Sampler` whose state
    carries its log density in ``state.lp`` (Transition-shaped states: the
    MH and MALA families).

    ``betas`` are inverse temperatures, strictly descending, with
    ``betas[0] == 1`` (the cold replica, whose draws are emitted).
    ``replica_scales`` multiplies a Gaussian random-walk inner sampler's
    scale per replica (see :meth:`geometric_scales`)."""

    sampler: Sampler
    betas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
    replica_scales: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if len(self.betas) < 2:
            raise ValueError("ReplicaExchange needs at least 2 temperatures")
        if abs(self.betas[0] - 1.0) > 1e-12:
            raise ValueError("betas[0] must be 1.0 (the cold chain)")
        if any(b2 >= b1 for b1, b2 in zip(self.betas, self.betas[1:])):
            raise ValueError("betas must be strictly descending")
        if any(b <= 0 for b in self.betas):
            raise ValueError("betas must be positive")
        if self.replica_scales is not None:
            rs = tuple(float(c) for c in self.replica_scales)
            if len(rs) != len(self.betas):
                raise ValueError(
                    f"replica_scales must match betas ({len(rs)} vs {len(self.betas)})")
            if any(c <= 0 for c in rs):
                raise ValueError("replica_scales must be positive")
            object.__setattr__(self, "replica_scales", rs)
            self._scaled_inner(1.0)  # validate the inner sampler now

    @staticmethod
    def geometric_scales(betas) -> Tuple[float, ...]:
        """The β^{-1/2} step-size ladder: a replica tempered to β targets a
        distribution whose scale grows like β^{-1/2} (exactly so for
        Gaussians), so hotter replicas take proportionally larger steps."""
        return tuple(float(b) ** -0.5 for b in betas)

    def _betas(self, device) -> torch.Tensor:
        return torch.tensor(self.betas, dtype=torch.float32, device=device)

    def _scaled_inner(self, c: float) -> Sampler:
        """The inner sampler with its random-walk scale multiplied by ``c``
        (a Gaussian random-walk MetropolisHastings inner only)."""
        from .mh import MetropolisHastings

        spl = self.sampler
        p = getattr(spl, "proposal", None)
        payload = getattr(p, "payload", None)
        if not (isinstance(spl, MetropolisHastings) and isinstance(p, RandomWalkProposal)
                and isinstance(payload, (Normal, MvNormal))):
            raise ValueError(
                "replica_scales requires a Gaussian random-walk MetropolisHastings inner sampler")
        if isinstance(payload, Normal):
            newp = Normal(payload.loc, payload.scale * c)
        elif payload.scale_tril is not None:
            newp = MvNormal(payload.loc, scale_tril=payload.scale_tril * c)
        elif payload.scale_diag is not None:
            newp = MvNormal(payload.loc, scale_diag=payload.scale_diag * c)
        else:
            newp = MvNormal(payload.loc, scale=payload.scale * c)
        return dataclasses.replace(spl, proposal=dataclasses.replace(p, payload=newp))

    # -- the (B, K) batch the inner sampler steps ------------------------------

    @staticmethod
    def _to_bk(inner, lead: int, K: int):
        """An inner state's leaves (lead..., K, ...) as (B, K, ...)."""
        return _map_fields(lambda v: v.reshape((-1, K) + tuple(v.shape[lead + 1:])), inner)

    @staticmethod
    def _from_bk(inner, lead_shape: Tuple[int, ...]):
        return _map_fields(lambda v: v.reshape(tuple(lead_shape) + tuple(v.shape[1:])), inner)

    def _inner_steps(self, gen, inner, model, lead_shape):
        """One tempered step of every replica: one batched inner step over
        (B, K), or with ``replica_scales`` one per replica with its scaled
        sampler."""
        K = len(self.betas)
        betas = self._betas(model.device)
        bk = self._to_bk(inner, len(lead_shape), K)
        B = int(bk.lp.shape[0])
        if self.replica_scales is None:
            _, out = self.sampler.step_batched(gen, bk, _tempered_model(model, betas), (B, K))
        else:
            outs = []
            for k in range(K):
                st = _map_fields(lambda v: v[:, k:k + 1], bk)
                _, s = self._scaled_inner(self.replica_scales[k]).step_batched(
                    gen, st, _tempered_model(model, betas[k:k + 1]), (B, 1))
                outs.append(s)
            out = _map_fields(lambda *vs: torch.cat(vs, 1), *outs)
        return self._from_bk(out, lead_shape)

    # -- the sampler protocol ----------------------------------------------------

    def init(self, gen, model, initial_params: Optional[Any] = None):
        return self._init(gen, as_model(model), (), initial_params, False)

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...], initial_params=None,
                     init_batched: bool = False):
        return self._init(gen, as_model(model), tuple(batch_shape), initial_params,
                          init_batched)

    def _init(self, gen, model, lead_shape, initial_params, init_batched):
        """Every replica initialised by the inner sampler on its tempered
        model: from ``initial_params`` (one point, or one per chain when
        ``init_batched``) or, without them, its own draws."""
        K = len(self.betas)
        B = int(np.prod(lead_shape)) if lead_shape else 1
        if initial_params is not None:
            if init_batched:
                initial_params = tree_map(
                    lambda v: v.reshape((B, 1) + tuple(v.shape[len(lead_shape):])).expand(
                        (B, K) + tuple(v.shape[len(lead_shape):])).clone(), initial_params)
            else:
                initial_params = tree_map(
                    lambda v: v.expand((B, K) + tuple(v.shape)).clone(), initial_params)
        _, inner = self.sampler.init_batched(gen, _tempered_model(model, self._betas(model.device)),
                                             (B, K), initial_params,
                                             init_batched=initial_params is not None)
        inner = self._from_bk(inner, lead_shape)
        zero = torch.zeros(tuple(lead_shape) + (K - 1,), dtype=torch.float32,
                           device=model.device)
        state = ReplicaExchangeState(inner, zero, zero.clone())
        return self.transition_of(state), state

    def transition_of(self, state: ReplicaExchangeState):
        """The cold (β = 1) replica's transition."""
        lead = _lead(state)
        return _map_fields(lambda v: v.select(lead, 0), state.inner)

    def step(self, gen, state: ReplicaExchangeState, model):
        return self.step_batched(gen, state, model, ())

    def step_batched(self, gen, state: ReplicaExchangeState, model,
                     batch_shape: Tuple[int, ...]):
        model = as_model(model)
        lead_shape = tuple(batch_shape)
        lead = len(lead_shape)
        K = len(self.betas)
        betas = self._betas(model.device)
        # 1. independent tempered inner steps
        inner = self._inner_steps(gen, state.inner, model, lead_shape)
        acc, prop = state.swap_accept_count, state.swap_proposal_count
        # 2. the even-odd swap sweep on the raw ℓ = lp/β
        ks = torch.arange(K - 1, device=model.device)
        idx = torch.arange(K, device=model.device)
        for parity in (0, 1):
            ell = inner.lp / betas
            active = (ks % 2) == parity
            logalpha = (betas[:-1] - betas[1:]) * (ell[..., 1:] - ell[..., :-1])
            u = torch.rand(lead_shape + (K - 1,), generator=gen, device=model.device)
            do_swap = active & (torch.log(u) < logalpha)
            no = torch.zeros(lead_shape + (1,), dtype=torch.bool, device=model.device)
            down = torch.cat([do_swap, no], -1)  # at k: take k+1
            up = torch.cat([no, do_swap], -1)  # at k+1: take k
            perm = torch.where(down, idx + 1, torch.where(up, idx - 1, idx))
            swapped = _map_fields(lambda v: _gather_replicas(v, perm, lead), inner)
            new_lp = betas * torch.gather(ell, lead, perm)
            swapped = dataclasses.replace(swapped, lp=new_lp)
            if hasattr(swapped, "gradient"):
                # the cached gradient is β∇ℓ: re-temper it to the receiving β
                scale = betas / betas[perm]
                swapped = dataclasses.replace(swapped, gradient=tree_map(
                    lambda g: g * scale.reshape(tuple(scale.shape) + (1,) * (g.ndim - scale.ndim)),
                    swapped.gradient))
            inner = swapped
            acc = acc + do_swap.to(torch.float32)
            prop = prop + active.to(torch.float32)
        new = ReplicaExchangeState(inner, acc, prop)
        return self.transition_of(new), new


def swap_rates(state: ReplicaExchangeState) -> torch.Tensor:
    """Observed adjacent-swap acceptance rates (..., K−1); tune ``betas``
    toward about 0.2-0.4 per pair."""
    return state.swap_accept_count / torch.clamp(state.swap_proposal_count, min=1.0)


def tune_betas(betas, rates, target: float = 0.3, step: float = 1.0):
    """One stochastic-approximation update of the temperature ladder from
    observed adjacent-swap rates (Miasojedow, Moulines and Vihola 2013): on
    the log-spacings ρ_k = log β_k − log β_{k+1},
    ``ρ_k ← ρ_k · exp(step · (rate_k − target))``; β₀ stays 1. Pass the
    chain-averaged :func:`swap_rates`. Returns a tuple for
    ``ReplicaExchange(..., betas=...)``."""
    b = np.asarray(betas, np.float64)
    r = rates.detach().cpu().numpy() if isinstance(rates, torch.Tensor) else rates
    r = np.asarray(r, np.float64).reshape(-1)
    if r.shape != (len(b) - 1,):
        raise ValueError(f"rates must have shape ({len(b) - 1},), got {r.shape}")
    rho = np.diff(-np.log(b))
    rho = rho * np.exp(step * (r - target))
    new = np.exp(-np.concatenate([[0.0], np.cumsum(rho)]))
    return tuple(float(x) for x in new)
