"""Prebuilt target models (≙ advancedmh_tpu/models/targets.py): the README
flagship, the correlated Gaussian of the RAM and MALA tests, and the emcee
test model.

A model that the fused engine can run carries, besides its per-chain
density, a *tile* density over the transposed chain block ``(d, C) ->
(1, C)`` (the plain version of the kernels' density), for gradient kernels
a tile value-and-gradient ``(d, C) -> ((1, C), (d, C))`` written by hand,
the constants both read, and ``cuda_density``: the name of the device
functor in ``csrc/common.cuh`` that the kernels instantiate for it.

Every constructor builds its tensors on ``device``: the card unless the
caller asks for another.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..distributions import InverseGamma, MvNormal, Normal
from ..ops.rwmh import row_sum
from .density import DensityModel, guarded_logdensity

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class TileDensityModel(DensityModel):
    """A DensityModel with a tile density for the fused engine."""

    tile_density: Optional[Callable] = None
    tile_value_and_grad: Optional[Callable] = None
    tile_consts: Tuple[torch.Tensor, ...] = ()
    cuda_density: Optional[str] = None


# ---- the (μ, σ) flagship -------------------------------------------------


def gaussian_mean_scale_tile(p: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Tile density of the (μ, σ) model: ``p`` (2, C), ``obs`` (n, 1).

    One reciprocal per chain instead of n divides; ``-inf`` where σ < 0.
    The CUDA functor ``GaussianMeanScale`` in ``csrc/common.cuh`` does the
    same algebra in the same order (the observations summed in order), so
    the two differ only in the last ulp of log.
    """
    n = obs.shape[0]
    mu, sigma = p[0:1], p[1:2]
    inv = 1.0 / torch.clamp(sigma, min=0.1)
    z = (obs - mu) * inv
    lp = row_sum(-0.5 * z * z) + n * torch.log(inv) - n * _HALF_LOG_2PI
    return torch.where(sigma >= 0, lp, torch.full_like(lp, -torch.inf))


def _gaussian_mean_scale_batched(theta: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """The flagship's density over a chain batch (C, 2) for the torch
    engine: the tile density's algebra with one ``torch.sum`` over the
    observations, where the tile density's ordered sum would cost a launch
    per observation on every step."""
    n = obs.shape[0]
    mu, sigma = theta[:, 0], theta[:, 1]
    inv = 1.0 / torch.clamp(sigma, min=0.1)
    z = (obs - mu) * inv
    lp = torch.sum(-0.5 * z * z, dim=0) + n * torch.log(inv) - n * _HALF_LOG_2PI
    return torch.where(sigma >= 0, lp, torch.full_like(lp, -torch.inf))


def gaussian_mean_scale_tile_value_and_grad(p: torch.Tensor, obs: torch.Tensor):
    """Value and gradient of :func:`gaussian_mean_scale_tile`, by hand.

    The gradient is the one reverse mode gives for the tile density: with
    m = max(σ, 0.1), inv = 1/m, r = obs − μ and z = r·inv,
    ``∂μ = inv·Σz``, ``∂inv = n·(1/inv) − Σ z·r`` and
    ``∂σ = (−∂inv)/(m·m)·w``, where w is 1 above σ = 0.1, 0.5 at it (the
    maximum splits its cotangent) and 0 below; both components are 0 where
    σ < 0 (the −inf branch carries no gradient). ``GaussianMeanScale::
    value_and_grad`` in ``csrc/common.cuh`` does the same algebra.
    """
    n = obs.shape[0]
    mu, sigma = p[0:1], p[1:2]
    m = torch.clamp(sigma, min=0.1)
    inv = 1.0 / m
    r = obs - mu
    z = r * inv
    lp = row_sum(-0.5 * z * z) + n * torch.log(inv) - n * _HALF_LOG_2PI
    d_inv = (1.0 / inv) * n - row_sum(z * r)
    one = torch.ones_like(sigma)
    w = torch.where(sigma > 0.1, one, torch.where(sigma == 0.1, 0.5 * one, 0.0 * one))
    grad = torch.cat([inv * row_sum(z), (-d_inv) / (m * m) * w])
    inside = sigma >= 0
    return (torch.where(inside, lp, torch.full_like(lp, -torch.inf)),
            torch.where(inside, grad, torch.zeros_like(grad)))


def gaussian_mean_scale_model(
    data=None, n_obs: int = 30, seed: int = 1234, device="cuda"
) -> TileDensityModel:
    """The reference README/test flagship: θ = (μ, σ) posterior of a Normal
    with a σ ≥ 0 support guard (reference README.md:23-40 and
    test/runtests.jl:22-31). ``data`` defaults to the JAX package's 30
    observations, ``np.random.default_rng(1234).normal(size=30)``."""
    if data is None:
        data = np.random.default_rng(seed).normal(size=n_obs)
    data = torch.as_tensor(np.asarray(data, np.float32), device=device)
    obs = data.reshape(-1, 1)

    def density(theta):
        return torch.sum(Normal(theta[0], theta[1]).log_prob(data))

    ld = guarded_logdensity(
        support_fn=lambda t: t[1] >= 0,
        logdensity_fn=density,
        safe_params_fn=lambda t: torch.stack([t[0], torch.clamp(t[1], min=0.1)]),
    )
    return TileDensityModel(
        logdensity_fn=ld,
        dimension=2,
        logdensity_batched_fn=lambda theta: _gaussian_mean_scale_batched(theta, obs),
        device=device,
        tile_density=gaussian_mean_scale_tile,
        tile_value_and_grad=gaussian_mean_scale_tile_value_and_grad,
        tile_consts=(obs,),
        cuda_density="gaussian_mean_scale",
    )


# ---- the correlated Gaussian ---------------------------------------------


def correlated_gaussian_tile_value_and_grad(x: torch.Tensor, prec: torch.Tensor,
                                            const: torch.Tensor):
    """Tile value ``-x'Px/2 + const`` and gradient ``-P x`` of the zero-mean
    Gaussian with precision ``prec`` (d, d); ``x`` (d, C). Sums run in the
    order of ``CorrelatedGaussian`` in ``csrc/common.cuh``."""
    d = x.shape[0]
    px = []
    for i in range(d):
        acc = prec[i, 0] * x[0:1]
        for j in range(1, d):
            acc = acc + prec[i, j] * x[j : j + 1]
        px.append(acc)
    q = x[0:1] * px[0]
    for i in range(1, d):
        q = q + x[i : i + 1] * px[i]
    return -0.5 * q + const, -torch.cat(px)


def correlated_gaussian_tile(x, prec, const):
    """Tile density of the correlated Gaussian (see above)."""
    return correlated_gaussian_tile_value_and_grad(x, prec, const)[0]


def correlated_gaussian_model(cov, device="cuda") -> TileDensityModel:
    """Zero-mean multivariate Gaussian target with covariance ``cov``
    (≙ the RAM doctest Gaussian and the MALA quadratic density of the
    reference tests, test/runtests.jl:317-364).

    The precision is inverted in float64 and symmetrised, so the gradient
    −P·x is the exact gradient of the float32 quadratic form."""
    cov = np.asarray(cov.cpu() if isinstance(cov, torch.Tensor) else cov, np.float64)
    d = cov.shape[0]
    prec64 = np.linalg.inv(cov)
    prec = torch.as_tensor(0.5 * (prec64 + prec64.T), dtype=torch.float32, device=device)
    const = torch.full((1, 1), -0.5 * math.log(np.linalg.det(2.0 * np.pi * cov)),
                       dtype=torch.float32, device=device)
    mv = MvNormal.from_cov(torch.zeros(d, dtype=torch.float32, device=device),
                           torch.as_tensor(cov, dtype=torch.float32, device=device))

    def ldg(x):
        return mv.log_prob(x), -(prec @ x)

    return TileDensityModel(
        logdensity_fn=mv.log_prob,
        logdensity_and_gradient_fn=ldg,
        dimension=d,
        logdensity_batched_fn=lambda x: correlated_gaussian_tile(x.T, prec, const)[0],
        device=device,
        tile_density=correlated_gaussian_tile,
        tile_value_and_grad=correlated_gaussian_tile_value_and_grad,
        tile_consts=(prec, const),
        cuda_density="correlated_gaussian",
    )


# ---- Bayesian logistic regression ----------------------------------------

# The observation sum of the tile density runs in 8 interleaved partial sums
# (observation i into partial i mod 8), then the partials in order: the
# order of LogisticRegression in csrc/common.cuh, where the 8 partials are
# independent chains of adds for the compiler to overlap.
_LOGREG_PARTIALS = 8


def _softplus(z: torch.Tensor) -> torch.Tensor:
    """``max(z, 0) + log1p(exp(-|z|))``, the overflow-stable form."""
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))


def _softplus_grad(z: torch.Tensor) -> torch.Tensor:
    """The derivative JAX's reverse mode gives for :func:`_softplus`:
    ``maximum`` splits its cotangent at the tie (½ at z = 0) and ``abs``
    takes the derivative +1 at 0, so with e = exp(−|z|)

        h(z) − s(z)·e/(1 + e),  h = 1, ½, 0 for z >, =, < 0,  s = ±1 (+ at 0),

    which is σ(z) away from 0 and exactly 0 at z = 0."""
    e = torch.exp(-torch.abs(z))
    one = torch.ones_like(z)
    h = torch.where(z > 0, one, torch.where(z == 0, 0.5 * one, 0.0 * one))
    s = torch.where(z >= 0, one, -one)
    return h - s * (e / (1.0 + e))


def _logits(b: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """z = X·b (n, C) with each z_i summed over the coordinates in order."""
    z = X[:, 0:1] * b[0:1]
    for j in range(1, X.shape[1]):
        z = z + X[:, j : j + 1] * b[j : j + 1]
    return z


def _interleaved_sum(a: torch.Tensor) -> torch.Tensor:
    """Σ_i a_i (n, C) → (1, C) in the kernel's order (see above)."""
    n, C = a.shape
    k = _LOGREG_PARTIALS
    pad = (-n) % k
    if pad:
        a = torch.cat([a, torch.zeros((pad, C), dtype=a.dtype, device=a.device)])
    blocks = a.reshape(-1, k, C)
    acc = blocks[0]
    for r in range(1, blocks.shape[0]):
        acc = acc + blocks[r]
    total = acc[0:1]
    for m in range(1, k):
        total = total + acc[m : m + 1]
    return total


def logistic_regression_tile(b: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                             inv_var: torch.Tensor) -> torch.Tensor:
    """Tile density of the logistic regression: ``b`` (d, C), ``X`` (n, d),
    ``y`` (n, 1), ``inv_var`` (1, 1) = 1/prior_scale²:

        Σ_i (y_i z_i − softplus(z_i)) − (inv_var/2)·Σ_j b_j²,  z = X·b.

    ``LogisticRegression`` in ``csrc/common.cuh`` does the same algebra in
    the same order."""
    return logistic_regression_tile_value_and_grad(b, X, y, inv_var, grad=False)[0]


def logistic_regression_tile_value_and_grad(b: torch.Tensor, X: torch.Tensor,
                                            y: torch.Tensor, inv_var: torch.Tensor,
                                            grad: bool = True):
    """Value and gradient of :func:`logistic_regression_tile`, by hand:
    ``g = Xᵀ(y − softplus'(z)) − inv_var·b`` with softplus' as JAX's reverse
    mode gives it (:func:`_softplus_grad`); the sum over observations runs
    in order i = 0, 1, ..., as in the kernel."""
    z = _logits(b, X)
    bb = b[0:1] * b[0:1]
    for j in range(1, b.shape[0]):
        bb = bb + b[j : j + 1] * b[j : j + 1]
    lp = _interleaved_sum(y * z - _softplus(z)) - (0.5 * inv_var) * bb
    if not grad:
        return lp, None
    r = y - _softplus_grad(z)  # (n, C)
    g = X[0][:, None] * r[0:1]
    for i in range(1, X.shape[0]):
        g = g + X[i][:, None] * r[i : i + 1]
    return lp, g - b * inv_var


def logistic_regression_model(
    n_obs: int = 256,
    dim: int = 32,
    *,
    prior_scale: float = 10.0,
    seed: int = 0,
    X=None,
    y=None,
    device="cuda",
) -> TileDensityModel:
    """Bayesian logistic regression (≙ the JAX package's
    ``logistic_regression_model``): β ~ N(0, prior_scale²·I),
    yᵢ ~ Bernoulli(σ(xᵢ·β)).

    Without ``X``/``y`` the synthetic dataset is drawn with
    ``np.random.default_rng(seed)`` in the JAX package's order (X, then
    β_true, then the uniforms), so X and y equal its bit for bit, and β_true
    is attached as ``model.beta_true``. The per-chain density, its gradient
    and the batched density of the torch engine use ``torch.matmul``, which
    runs in IEEE float32 on the card (``torch.backends.cuda.matmul.
    allow_tf32`` is False by default; chip_smoke.py sets it so). The tile
    forms are the kernels' plain versions (see above)."""
    beta_true = None
    if X is None:
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n_obs, dim)).astype(np.float32) / np.sqrt(dim)
        beta_true = 2.0 * rng.normal(size=(dim,)).astype(np.float32)
        logits = X @ beta_true
        y = (rng.uniform(size=n_obs) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    elif y is None:
        raise ValueError("supply y along with X")
    X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    n, d = X.shape
    inv_var = 1.0 / float(prior_scale) ** 2
    half_inv_var = 0.5 * inv_var

    def logdensity(beta):
        z = X @ beta
        return torch.sum(y * z - _softplus(z)) - half_inv_var * torch.sum(beta * beta)

    def ldg(beta):
        z = X @ beta
        lp = torch.sum(y * z - _softplus(z)) - half_inv_var * torch.sum(beta * beta)
        return lp, X.T @ (y - torch.sigmoid(z)) - inv_var * beta

    def batched(betas):  # (C, d) -> (C,): one matmul for all chains
        z = betas @ X.T
        ll = torch.sum(y[None, :] * z - _softplus(z), dim=1)
        return ll - half_inv_var * torch.sum(betas * betas, dim=1)

    model = TileDensityModel(
        logdensity_fn=logdensity,
        logdensity_and_gradient_fn=ldg,
        dimension=d,
        logdensity_batched_fn=batched,
        device=device,
        tile_density=logistic_regression_tile,
        tile_value_and_grad=logistic_regression_tile_value_and_grad,
        tile_consts=(X, y.reshape(-1, 1),
                     torch.full((1, 1), inv_var, dtype=torch.float32, device=device)),
        cuda_density="logistic_regression",
    )
    if beta_true is not None:
        object.__setattr__(model, "beta_true", beta_true)
    return model


# ---- Neal's funnel -------------------------------------------------------

def _funnel_const(d: int) -> float:
    """log normaliser of the funnel, −½·log(2π·9) − (d−1)·½·log(2π), as
    ``NealFunnel`` in csrc/common.cuh computes it in float64: −d·½·log(2π) −
    log 3 from the same two literals."""
    return -d * 0.91893853320467274178 - 1.0986122886681098


def neal_funnel_tile_value_and_grad(t: torch.Tensor, grad: bool = True):
    """Tile value and gradient of the funnel, ``t`` (d, C) = (v, x_1..x_{d−1}):

        lp = ((−v)·v)/18 − (d−1)/2·v − (e/2)·Σx² + c,  e = exp(−v),

    and the gradient with the algebra JAX's reverse mode gives the tile
    density: with a = (−v)·(1/18), ``∂v = (a + a − (d−1)/2) + (Σx²/2)·e`` and
    ``∂x = (−e/2)·x + (−e/2)·x``. For v < −88 exp(−v) overflows to inf, and
    inf·0 is NaN where Σx² or x is 0, as in JAX. ``NealFunnel`` in
    csrc/common.cuh does the same operations in the same order."""
    d = t.shape[0]
    v, x = t[0:1], t[1:]
    sq = row_sum(x * x)
    e = torch.exp(-v)
    he = 0.5 * e
    lp = ((-v) * v / torch.full_like(v, 18.0) - (0.5 * (d - 1)) * v) - he * sq + _funnel_const(d)
    if not grad:
        return lp, None
    c18 = torch.ones_like(v) / torch.full_like(v, 18.0)
    a = (-v) * c18
    gv = (a + a - 0.5 * (d - 1)) + (0.5 * sq) * e
    gx = (-he) * x
    return lp, torch.cat([gv, gx + gx])


def neal_funnel_tile(t: torch.Tensor) -> torch.Tensor:
    """Tile density of the funnel (see :func:`neal_funnel_tile_value_and_grad`)."""
    return neal_funnel_tile_value_and_grad(t, grad=False)[0]


def neal_funnel_model(d: int = 10, device="cuda") -> TileDensityModel:
    """Neal's funnel (Neal 2003 §8; ≙ the JAX package's ``neal_funnel_model``):
    v ~ N(0, 3²), x_i | v ~ N(0, eᵛ) for i = 1..d−1, θ = (v, x_1..x_{d−1}),

        log π = −v²/18 − (d−1)v/2 − e^{−v}·Σx²/2 + C.

    The marginal of v is N(0, 9), so the neck mass is P(v < −c) = Φ(−c/3).
    ``logdensity`` and the per-chain ``ldg`` are the JAX model's closed forms;
    the tile forms are the kernels' plain versions."""
    dm1 = d - 1
    const = float(-0.5 * math.log(2.0 * math.pi * 9.0) - dm1 * _HALF_LOG_2PI)

    def logdensity(theta):
        v, x = theta[0], theta[1:]
        return -v * v / 18.0 - 0.5 * dm1 * v - 0.5 * torch.exp(-v) * torch.sum(x * x) + const

    def ldg(theta):
        v, x = theta[0], theta[1:]
        e = torch.exp(-v)
        sq = torch.sum(x * x)
        lp = -v * v / 18.0 - 0.5 * dm1 * v - 0.5 * e * sq + const
        gv = -v / 9.0 - 0.5 * dm1 + 0.5 * e * sq
        return lp, torch.cat([gv[None], -e * x])

    return TileDensityModel(
        logdensity_fn=logdensity,
        logdensity_and_gradient_fn=ldg,
        dimension=d,
        logdensity_batched_fn=lambda th: neal_funnel_tile(th.T)[0],
        device=device,
        tile_density=neal_funnel_tile,
        tile_value_and_grad=neal_funnel_tile_value_and_grad,
        tile_consts=(),
        cuda_density="neal_funnel",
    )


# ---- the emcee test model ------------------------------------------------

_IG_CONST = 2.0 * math.log(3.0)  # InverseGamma(2, 3): α log θ − lgamma(2)


def _emcee_joint(log_s, inv_s, m):
    """Closed form of the joint density at s (given log s and 1/s) and m:
    IG(2, 3) + N(0, √s)(m) + N(m, √s)(1.5) + N(m, √s)(2.0)."""
    quad = m * m + (1.5 - m) * (1.5 - m) + (2.0 - m) * (2.0 - m)
    return (
        _IG_CONST
        - 3.0 * log_s
        - 3.0 * inv_s
        - 1.5 * log_s
        - 3.0 * _HALF_LOG_2PI
        - 0.5 * quad * inv_s
    )


def emcee_demo_tile(x: torch.Tensor) -> torch.Tensor:
    """Tile density of the emcee test model, x = (s, m) rows (2, C). Out of
    the support (s <= 0) it is −1e30, not −inf, as in the JAX model, so a
    stretch move's logα never becomes NaN. ``EmceeDemo`` in
    ``csrc/common.cuh`` does the same algebra."""
    s, m = x[0:1], x[1:2]
    safe_s = torch.clamp(s, min=1e-6)
    lp = _emcee_joint(torch.log(safe_s), 1.0 / safe_s, m)
    return torch.where(s > 0, lp, torch.full_like(lp, -1e30))


def emcee_demo_tile_transformed(x: torch.Tensor) -> torch.Tensor:
    """Tile density in (log s, m) with the log transform's Jacobian."""
    logs, m = x[0:1], x[1:2]
    return _emcee_joint(logs, torch.exp(-logs), m) + logs


def emcee_demo_model(transformed: bool = False, device="cuda") -> TileDensityModel:
    """The reference emcee test model (test/emcee.jl): s ~ InverseGamma(2,3),
    m ~ N(0, √s), observations 1.5 and 2.0 from N(m, √s). Analytic posterior
    means s̄ = 49/24, m̄ = 7/6. ``transformed=True`` uses (log s, m) with the
    Jacobian correction; only the untransformed model has a CUDA functor."""
    ig = InverseGamma(2.0, 3.0)

    def joint(s, m):
        sqrts = torch.sqrt(s)
        return (ig.log_prob(s) + Normal(0.0, sqrts).log_prob(m)
                + Normal(m, sqrts).log_prob(1.5) + Normal(m, sqrts).log_prob(2.0))

    if transformed:
        def logprob(theta):
            return joint(torch.exp(theta[0]), theta[1]) + theta[0]

        return TileDensityModel(logdensity_fn=logprob, dimension=2, device=device,
                                tile_density=emcee_demo_tile_transformed)

    def logprob(theta):
        s, m = theta[0], theta[1]
        lp = joint(torch.clamp(s, min=1e-6), m)
        return torch.where(s > 0, lp, torch.full_like(lp, -torch.inf))

    return TileDensityModel(logdensity_fn=logprob, dimension=2, device=device,
                            tile_density=emcee_demo_tile, cuda_density="emcee_demo")
