"""ChEES-HMC: cross-chain trajectory-length adaptation
(≙ advancedmh_tpu/samplers/chees.py; Hoffman, Radul & Sountsov, AISTATS 2021).

One trajectory length T is shared by the whole chain batch and tuned by
Adam ascent on log T against the ChEES criterion
``(1/4)·E[(‖x′ − μ‖² − ‖x − μ‖²)²]``, whose gradient comes from the
cross-chain batch: each chain contributes Δ·⟨x′ − μ′, M⁻¹p′⟩ weighted by its
acceptance probability. Warmup also adapts one shared ε (dual averaging on
the mean acceptance probability toward ``target_accept``) and, with
``adapt_mass``, a pooled Welford diagonal M⁻¹ (Stan-regularised, ≙ pooled
AdaptiveHMC). After warmup (ε̄, T̄, M⁻¹) freeze; every iteration keeps a
U(0, 1) jitter of the trajectory, ``L = clip(round(u·T/ε), 1, max_leapfrog)``
leapfrog steps shared by all chains (``round`` is half to even).

The statistics are stored replicated over the chains; ``_shared`` reads the
first. With no chain batch (``step`` / ``step_warmup``) there is no ChEES
signal: the warmup adapts ε and a per-chain mass and holds T.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..models.density import as_model
from ..utils.tree import tree_flatten, tree_map
from .base import GradientTransition, Sampler, select_tree
from .hmc import HamiltonianMC, _tree_sum
from .hmc_adapt import AdaptiveHMC, _bcast


def _event_sum(leaf: torch.Tensor, bn: int) -> torch.Tensor:
    """Sum over all but the first ``bn`` (batch) axes."""
    return leaf if leaf.ndim == bn else torch.sum(leaf, dim=tuple(range(bn, leaf.ndim)))


@dataclasses.dataclass(frozen=True)
class ChEESHMCState:
    """Batched HMC transition + shared (replicated) adaptation statistics."""

    inner: GradientTransition
    log_eps: torch.Tensor  # shared log step size (dual-averaging iterate)
    log_eps_bar: torch.Tensor  # running average, frozen post-warmup
    h_bar: torch.Tensor  # dual-averaging error sum
    log_traj: torch.Tensor  # shared log trajectory length T (Adam iterate)
    log_traj_bar: torch.Tensor  # running average, frozen post-warmup
    adam_m: torch.Tensor  # Adam first moment for log T
    adam_v: torch.Tensor  # Adam second moment for log T
    t: torch.Tensor  # warmup iteration counter (int32, starts at 1)
    mean: Any  # Welford mass moments (params-shaped trees)
    m2: Any
    n: torch.Tensor
    inverse_mass: Any


@dataclasses.dataclass(frozen=True)
class ChEESHMC(Sampler):
    """HMC with shared cross-chain (T, ε[, diag M⁻¹]) warmup adaptation.

    ``max_leapfrog`` bounds the leapfrog steps of one iteration; the adapted
    T is clipped so that ``T/ε ≤ max_leapfrog``."""

    initial_trajectory_length: float = 1.0
    initial_step_size: float = 0.1
    target_accept: float = 0.65
    max_leapfrog: int = 256
    adapt_mass: bool = True
    learning_rate: float = 0.025  # Adam rate on log T (the paper's setting)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    t0: float = 10.0  # dual-averaging hyperparameters (HG14 §3.2)
    kappa: float = 0.75
    gamma: float = 0.05
    mu: Optional[float] = None
    mass_regularization: float = 5.0  # ≙ AdaptiveHMC
    mass_warm_start: int = 10

    def __post_init__(self):
        if self.initial_trajectory_length <= 0.0:
            raise ValueError("initial_trajectory_length must be positive")
        if self.initial_step_size <= 0.0:
            raise ValueError("initial_step_size must be positive")
        if not 0.0 < self.target_accept < 1.0:
            raise ValueError("target_accept must be in (0, 1)")
        if int(self.max_leapfrog) < 1:
            raise ValueError("max_leapfrog must be >= 1")
        if self.learning_rate <= 0.0:
            raise ValueError("learning_rate must be positive")
        if not 0.0 <= self.adam_b1 < 1.0 or not 0.0 <= self.adam_b2 < 1.0:
            raise ValueError("adam_b1/adam_b2 must be in [0, 1)")
        if self.gamma <= 0.0:
            raise ValueError("gamma must be positive")
        if self.t0 < 0.0:
            raise ValueError("t0 must be non-negative")
        if not 0.0 < self.kappa <= 1.0:
            raise ValueError("kappa must be in (0, 1]")
        if self.mass_regularization < 0.0:
            raise ValueError("mass_regularization must be non-negative")

    # -- shared helpers ----------------------------------------------------

    @property
    def _mu(self) -> float:
        return math.log(10.0 * self.initial_step_size) if self.mu is None else self.mu

    @staticmethod
    def _shared(x: torch.Tensor) -> torch.Tensor:
        """First element of a replicated statistic (the scalar of one chain)."""
        return x.reshape(-1)[0]

    def transition_of(self, state: ChEESHMCState) -> GradientTransition:
        return state.inner

    def _n_steps(self, traj: torch.Tensor, eps: torch.Tensor) -> int:
        """``clip(round(traj/ε), 1, max_leapfrog)`` (float32 ratio, half to
        even; NaN converts to 0 and clips to 1, as XLA converts it)."""
        r = float(traj / eps)
        if r != r:
            return 1
        r = min(max(r, -2.0**31), 2.0**31 - 1)
        return int(min(max(round(r), 1), int(self.max_leapfrog)))

    def _dual_avg_eps(self, state: ChEESHMCState, accept_prob_mean):
        ts = self._shared(state.t).to(torch.float32)
        w = 1.0 / (ts + self.t0)
        h_bar = (1.0 - w) * self._shared(state.h_bar) + w * (self.target_accept - accept_prob_mean)
        log_eps = self._mu - torch.sqrt(ts) / self.gamma * h_bar
        eta = torch.pow(ts, -self.kappa)
        log_eps_bar = eta * log_eps + (1.0 - eta) * self._shared(state.log_eps_bar)
        return log_eps, log_eps_bar, h_bar

    def _adam_update(self, state: ChEESHMCState, grad_log_T, eps_now):
        """Adam ascent on log T, then clip so that 1 ≤ T/ε ≤ max_leapfrog."""
        ts = self._shared(state.t).to(torch.float32)
        m = self.adam_b1 * self._shared(state.adam_m) + (1.0 - self.adam_b1) * grad_log_T
        v = (self.adam_b2 * self._shared(state.adam_v)
             + (1.0 - self.adam_b2) * grad_log_T * grad_log_T)
        m_hat = m / (1.0 - torch.pow(torch.tensor(self.adam_b1, device=ts.device), ts))
        v_hat = v / (1.0 - torch.pow(torch.tensor(self.adam_b2, device=ts.device), ts))
        log_T = self._shared(state.log_traj) + self.learning_rate * m_hat / (
            torch.sqrt(v_hat) + 1e-8)
        lo = torch.log(eps_now)
        hi = torch.log(float(self.max_leapfrog) * eps_now)
        log_T = torch.minimum(torch.maximum(log_T, lo), hi)  # jnp.clip: NaN stays NaN
        eta = torch.pow(ts, -self.kappa)
        log_T_bar = eta * log_T + (1.0 - eta) * self._shared(state.log_traj_bar)
        return log_T, log_T_bar, m, v

    # -- mass adaptation: AdaptiveHMC's (Stan-regularised estimate, per-chain
    # and pooled Chan-Golub-LeVeque Welford merges), as in the JAX package

    _regularized_inverse_mass = AdaptiveHMC._regularized_inverse_mass
    _welford_pooled = staticmethod(AdaptiveHMC._welford_update_pooled)
    _welford_single = staticmethod(AdaptiveHMC._welford_update)

    # -- init ----------------------------------------------------------------

    def _fresh(self, inner: GradientTransition, batch_shape) -> ChEESHMCState:
        dev = inner.lp.device
        full = lambda v: torch.full(tuple(batch_shape), v, dtype=torch.float32, device=dev)
        log_eps0 = torch.log(full(self.initial_step_size))
        log_T0 = torch.log(full(self.initial_trajectory_length))
        return ChEESHMCState(
            inner=inner, log_eps=log_eps0, log_eps_bar=log_eps0.clone(), h_bar=full(0.0),
            log_traj=log_T0, log_traj_bar=log_T0.clone(), adam_m=full(0.0),
            adam_v=full(0.0),
            t=torch.ones(tuple(batch_shape), dtype=torch.int32, device=dev),
            mean=tree_map(lambda x: x.to(torch.float32).clone(), inner.params),
            m2=tree_map(torch.zeros_like, inner.params), n=full(0.0),
            inverse_mass=tree_map(torch.ones_like, inner.params),
        )

    def init(self, gen, model, initial_params: Optional[Any] = None):
        t, inner = HamiltonianMC(self.initial_step_size, 1).init(gen, model, initial_params)
        return t, self._fresh(inner, ())

    def init_batched(self, gen, model, batch_shape: Tuple[int, ...],
                     initial_params=None, init_batched: bool = False):
        t, inner = HamiltonianMC(self.initial_step_size, 1).init_batched(
            gen, model, batch_shape, initial_params, init_batched)
        return t, self._fresh(inner, batch_shape)

    # -- the trajectory --------------------------------------------------------

    def _trajectory(self, state: ChEESHMCState, model, bn: int, z, e, u, traj, eps):
        """One jittered shared-length trajectory from the noise: standard
        normals ``z`` (the params' structure), Exp(1) draws ``e`` for the
        accept ``-e < logα`` and the jitter ``u``; the leapfrog and energy
        are HamiltonianMC's at (ε, M⁻¹). Returns (x1, p1, lp1, grad1, logα,
        accepted, traj_len)."""
        traj_len = u * traj
        hmc = HamiltonianMC(eps, self._n_steps(traj_len, eps),
                            inverse_mass=state.inverse_mass)
        x, lp = state.inner.params, state.inner.lp
        p0 = hmc._momentum(z, x)
        x1, p1, lp1, grad1 = hmc._trajectory(HamiltonianMC._vg(as_model(model), bn), x, p0,
                                             lp, state.inner.gradient)
        logalpha = (lp1 - hmc._kinetic(p1, x1, bn)) - (lp - hmc._kinetic(p0, x, bn))
        return x1, p1, lp1, grad1, logalpha, -e < logalpha, traj_len

    def _select_inner(self, state, x1, lp1, grad1, accepted):
        return GradientTransition(select_tree(accepted, x1, state.inner.params),
                                  torch.where(accepted, lp1, state.inner.lp),
                                  select_tree(accepted, grad1, state.inner.gradient),
                                  accepted)

    def _chees_grad(self, state, x1, p1, w, traj_len, batch_shape):
        """Acceptance-weighted ChEES gradient w.r.t. log T:
        E[Δ·⟨x′ − μ′, M⁻¹p′⟩], Δ = ‖x′ − μ′‖² − ‖x − μ‖², times u·T.

        Divergence guards (Neal's funnel): a chain whose end point or
        momentum is non-finite or beyond 1e10 is left out of the centring
        means and the gradient; a non-finite contribution counts 0 and each
        is clipped to ±1e30 so that the sum cannot overflow."""
        bn = len(batch_shape)
        axes = tuple(range(bn))

        def chain_finite(tree):
            leaves, _ = tree_flatten(tree)
            ok = None
            for leaf in leaves:
                f = torch.abs(leaf) < 1e10
                f = f if f.ndim == bn else f.all(dim=tuple(range(bn, f.ndim)))
                ok = f if ok is None else ok & f
            return ok

        healthy = (chain_finite(x1) & chain_finite(p1)).to(torch.float32)
        cnt = torch.clamp(torch.sum(healthy), min=1.0)

        def center(tree):
            def leaf(l):
                hb = _bcast(healthy, l)
                mean = torch.sum(torch.where(hb > 0, l, torch.zeros_like(l)), dim=axes,
                                 keepdim=True) / cnt
                return l - mean

            return tree_map(leaf, tree)

        x0c, x1c = center(state.inner.params), center(x1)
        sq = lambda tree: _tree_sum(tree_map(lambda l: _event_sum(l * l, bn), tree))
        delta = sq(x1c) - sq(x0c)
        vel = tree_map(lambda pp, m: pp * m, p1, state.inverse_mass)
        dot = _tree_sum(tree_map(lambda a, b: _event_sum(a * b, bn), x1c, vel))
        contrib = w * delta * dot * healthy
        contrib = torch.where(torch.isfinite(contrib), contrib, torch.zeros_like(contrib))
        contrib = torch.clamp(contrib, -1e30, 1e30)
        num = torch.sum(contrib)
        den = torch.clamp(torch.sum(w * healthy), min=1e-6)
        return torch.clamp(traj_len * num / den, -1e6, 1e6)

    # -- batched kernels (the ChEES hot path) ------------------------------

    def _draw(self, gen, state, batch_shape):
        z = tree_map(lambda x: torch.randn(x.shape, generator=gen, device=gen.device),
                     state.inner.params)
        e = torch.empty(tuple(batch_shape), device=gen.device).exponential_(generator=gen)
        u = torch.rand((), generator=gen, device=gen.device)
        return z, e, u

    def step_warmup_from_noise(self, state: ChEESHMCState, model, batch_shape, z, e, u):
        """One warmup iteration from given noise (see :meth:`_trajectory`)."""
        bn = len(batch_shape)
        eps = torch.exp(self._shared(state.log_eps))
        traj = torch.exp(self._shared(state.log_traj))
        x1, p1, lp1, grad1, logalpha, accepted, traj_len = self._trajectory(
            state, model, bn, z, e, u, traj, eps)
        t_inner = self._select_inner(state, x1, lp1, grad1, accepted)
        # a divergent trajectory's logα may be NaN: acceptance probability 0
        w = torch.where(torch.isfinite(logalpha), torch.exp(torch.clamp(logalpha, max=0.0)),
                        torch.zeros_like(logalpha))
        log_eps, log_eps_bar, h_bar = self._dual_avg_eps(state, torch.mean(w))
        g = self._chees_grad(state, x1, p1, w, traj_len, batch_shape)
        log_T, log_T_bar, m, v = self._adam_update(state, g, torch.exp(log_eps))
        if self.adapt_mass:
            mean, m2, n = self._welford_pooled(state.mean, state.m2, state.n, t_inner.params,
                                               batch_shape)
            inv_mass = self._regularized_inverse_mass(m2, n, state.inverse_mass)
        else:
            mean, m2, n, inv_mass = state.mean, state.m2, state.n, state.inverse_mass
        b = lambda s: s.broadcast_to(tuple(batch_shape)).clone()
        return t_inner, ChEESHMCState(
            inner=t_inner, log_eps=b(log_eps), log_eps_bar=b(log_eps_bar), h_bar=b(h_bar),
            log_traj=b(log_T), log_traj_bar=b(log_T_bar), adam_m=b(m), adam_v=b(v),
            t=state.t + 1, mean=mean, m2=m2, n=n, inverse_mass=inv_mass)

    def step_from_noise(self, state: ChEESHMCState, model, batch_shape, z, e, u):
        """One frozen iteration from given noise: (ε̄, T̄, M⁻¹) held, the
        jitter kept."""
        eps = torch.exp(self._shared(state.log_eps_bar))
        traj = torch.exp(self._shared(state.log_traj_bar))
        x1, _, lp1, grad1, _, accepted, _ = self._trajectory(
            state, model, len(batch_shape), z, e, u, traj, eps)
        t_inner = self._select_inner(state, x1, lp1, grad1, accepted)
        return t_inner, dataclasses.replace(state, inner=t_inner)

    def step_warmup_batched(self, gen, state: ChEESHMCState, model, batch_shape):
        return self.step_warmup_from_noise(state, model, batch_shape,
                                           *self._draw(gen, state, batch_shape))

    def step_batched(self, gen, state: ChEESHMCState, model, batch_shape):
        """Post-warmup: frozen (ε̄, T̄, M⁻¹); the jitter stays (anti-resonance)."""
        return self.step_from_noise(state, model, batch_shape,
                                    *self._draw(gen, state, batch_shape))

    # -- one chain (degraded: no cross-chain ChEES signal) ---------------------

    def _step_single(self, gen, state: ChEESHMCState, model, eps, traj, adapt: bool):
        z, e, u = self._draw(gen, state, ())
        x1, _, lp1, grad1, logalpha, accepted, _ = self._trajectory(
            state, model, 0, z, e, u, traj, eps)
        t_inner = self._select_inner(state, x1, lp1, grad1, accepted)
        if not adapt:
            return t_inner, dataclasses.replace(state, inner=t_inner)
        w = torch.where(torch.isfinite(logalpha), torch.exp(torch.clamp(logalpha, max=0.0)),
                        torch.zeros_like(logalpha))
        log_eps, log_eps_bar, h_bar = self._dual_avg_eps(state, w)
        mean, m2, n = self._welford_single(state.mean, state.m2, state.n, t_inner.params)
        inv_mass = (self._regularized_inverse_mass(m2, n, state.inverse_mass)
                    if self.adapt_mass else state.inverse_mass)
        return t_inner, dataclasses.replace(
            state, inner=t_inner, log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar,
            t=state.t + 1, mean=mean, m2=m2, n=n, inverse_mass=inv_mass)

    def step(self, gen, state: ChEESHMCState, model):
        return self._step_single(gen, state, model, torch.exp(state.log_eps_bar),
                                 torch.exp(state.log_traj_bar), adapt=False)

    def step_warmup(self, gen, state: ChEESHMCState, model):
        """Single-chain warmup: ε + per-chain mass only (T needs chains)."""
        return self._step_single(gen, state, model, torch.exp(state.log_eps),
                                 torch.exp(state.log_traj), adapt=True)
