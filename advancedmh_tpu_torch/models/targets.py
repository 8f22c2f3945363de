"""Prebuilt target models (≙ advancedmh_tpu/models/targets.py): the README
flagship, the correlated Gaussian of the RAM and MALA tests, the Bayesian
logistic regression, Neal's funnel, the Haario banana, the GP latent field,
the emcee test model, the two-mode mixture that checks the tempering
kernel, and the conjugate Normal-mean and flat likelihoods that check the
evidence kernel.

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
from ..ops.rwmh import row_sum, softplus
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

    With ``prior_scale=math.inf`` the prior term's ``inv_var = 1/prior_scale²``
    is exactly 0 (as in the JAX model), so every form of the density is the
    pure log-likelihood: the likelihood model of ``log_evidence``, whose prior
    is then passed on its own.

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


# ---- the Haario banana -------------------------------------------------------


def _banana_value_and_grad(x1, x2, c, grad: bool = True):
    """The banana's value (and gradient) at coordinates ``x1``, ``x2`` of any
    shape, ``c`` = (b, σ₁², b·σ₁², const) indexed on its first axis:

        y₂ = (x₂ + (b·x₁)·x₁) − b·σ₁²,  lp = ((−½x₁)·x₁)/σ₁² − (½y₂)·y₂ + const,
        ∂x₁ = (−x₁)/σ₁² − ((y₂·2)·b)·x₁,  ∂x₂ = −y₂,

    the JAX model's operations in its order (it divides by σ₁²). ``Banana``
    in csrc/common.cuh does the same."""
    b, s2, bs2, cst = c[0], c[1], c[2], c[3]
    y2 = (x2 + b * x1 * x1) - bs2
    lp = (-0.5 * x1) * x1 / s2 - (0.5 * y2) * y2 + cst
    if not grad:
        return lp, None
    return lp, ((-x1) / s2 - y2 * 2.0 * b * x1, -y2)


def banana_tile_value_and_grad(x: torch.Tensor, c: torch.Tensor, grad: bool = True):
    """Tile value ``(1, C)`` and gradient ``(2, C)`` of the banana at ``x``
    (2, C); ``c`` the (4, 1) constants (see :func:`_banana_value_and_grad`)."""
    lp, g = _banana_value_and_grad(x[0:1], x[1:2], c, grad)
    return lp, (None if g is None else torch.cat(g))


def banana_tile(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Tile density of the banana (see :func:`banana_tile_value_and_grad`)."""
    return banana_tile_value_and_grad(x, c, grad=False)[0]


def banana_model(b: float = 0.03, sigma1: float = 10.0, device="cuda") -> TileDensityModel:
    """Haario banana (≙ the JAX package's ``banana_model``; Haario, Saksman
    and Tamminen 1999): y₁ ~ N(0, σ₁²), y₂ ~ N(0, 1) pushed through the twist
    x = (y₁, y₂ − b·y₁² + b·σ₁²), a curved ridge. The twist preserves volume,
    so E[x] = 0, Var[x₁] = σ₁², Var[x₂] = 1 + 2b²σ₁⁴ (19 at the defaults).

    The constants b, σ₁², b·σ₁² and const = −½·log(2πσ₁²) − ½·log 2π are
    each rounded once from float64 to float32, as the JAX model's Python
    floats are; every form (per chain, batched, tile) runs the same
    operations in the same order."""
    s1_sq = float(sigma1) ** 2
    const = -0.5 * math.log(2.0 * math.pi * s1_sq) - _HALF_LOG_2PI
    c = torch.tensor([[b], [s1_sq], [b * s1_sq], [const]], dtype=torch.float32,
                     device=device)
    flat = c.reshape(-1)

    def logdensity(x):
        return _banana_value_and_grad(x[..., 0], x[..., 1], flat, grad=False)[0]

    def ldg(x):
        lp, (g0, g1) = _banana_value_and_grad(x[0], x[1], flat)
        return lp, torch.stack([g0, g1])

    return TileDensityModel(
        logdensity_fn=logdensity,
        logdensity_and_gradient_fn=ldg,
        dimension=2,
        logdensity_batched_fn=logdensity,
        device=device,
        tile_density=banana_tile,
        tile_value_and_grad=banana_tile_value_and_grad,
        tile_consts=(c,),
        cuda_density="banana",
    )


# ---- the Gaussian-process latent field -------------------------------------


def gp_regression_tile(f: torch.Tensor, y: torch.Tensor, inv2: torch.Tensor,
                       norm: torch.Tensor) -> torch.Tensor:
    """Tile log-likelihood of the GP regression, ``f`` (d, C), ``y`` (d, 1),
    ``inv2`` = 1/noise² and ``norm`` = d·(½log 2π + log noise) (1, 1):
    ``(−½·inv2)·Σ(y − f)² − norm``, summed over the points in order, as
    ``GPRegression`` in csrc/common.cuh."""
    r = y - f
    return (-0.5 * inv2) * row_sum(r * r) - norm


def gp_classification_tile(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Tile log-likelihood of GP classification, y ∈ {−1, +1} (d, 1):
    ``−Σ softplus((−y)·f)`` over the points in order (softplus in the JAX
    tile's max + log(1 + exp(−|t|)) form, ops/rwmh.py::softplus), as
    ``GPClassification`` in csrc/common.cuh."""
    return -row_sum(softplus((-y) * f))


def gp_latent_model(
    n_points: int = 64,
    likelihood: str = "gaussian",
    noise: float = 0.25,
    lengthscale: float = 0.2,
    amplitude: float = 1.0,
    seed: int = 0,
    device="cuda",
):
    """1-D Gaussian-process latent field on a uniform grid of [0, 1] (≙ the
    JAX package's ``gp_latent_model``), the target of ``EllipticalSlice``
    and ``PreconditionedCrankNicolson``: f ~ N(0, K) with an RBF kernel, and
    observations of a ground-truth draw.

    Returns ``(model, prior, aux)``: ``model``'s density is the
    **log-likelihood only**, ``prior`` is ``MvNormal(0, scale_tril=chol(K))``
    and ``aux`` holds (numpy, float64) the grid ``x``, ``f_true``, ``y`` and,
    for ``likelihood="gaussian"``, the closed-form ``post_mean`` and
    ``post_cov``. Grid, K, its Cholesky factor and the data are made with the
    JAX package's numpy calls in its order, so they equal its bit for bit.
    ``likelihood="logistic"`` is GP classification (y ∈ {−1, +1}, log σ(y·f)
    per point)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n_points, dtype=np.float64)
    sq = (x[:, None] - x[None, :]) ** 2
    K = amplitude**2 * np.exp(-0.5 * sq / lengthscale**2)
    K += 1e-6 * np.eye(n_points)
    L = np.linalg.cholesky(K)
    f_true = L @ rng.normal(size=n_points)
    prior = MvNormal(torch.zeros(n_points, dtype=torch.float32, device=device),
                     scale_tril=torch.as_tensor(L, dtype=torch.float32, device=device))
    aux = {"x": x, "f_true": f_true}
    if likelihood == "gaussian":
        y = f_true + noise * rng.normal(size=n_points)
        A = np.linalg.solve(K + noise**2 * np.eye(n_points), K)
        aux["post_mean"] = K @ np.linalg.solve(K + noise**2 * np.eye(n_points), y)
        aux["post_cov"] = K - K @ A
    elif likelihood == "logistic":
        y = np.where(f_true + noise * rng.normal(size=n_points) > 0, 1.0, -1.0)
    else:
        raise ValueError(f"unknown likelihood {likelihood!r}")
    aux["y"] = y
    return _gp_model(y, likelihood, noise, device), prior, aux


def _gp_model(y, likelihood: str, noise: float, device) -> TileDensityModel:
    """The GP latent field's likelihood model on the observations ``y``."""
    n = len(y)
    y_t = torch.as_tensor(np.asarray(y, np.float32), device=device)
    col = y_t.reshape(-1, 1)
    if likelihood == "gaussian":
        inv2 = 1.0 / (noise * noise)
        norm = n * (_HALF_LOG_2PI + math.log(noise))

        def loglik(f):
            r = y_t - f
            return -0.5 * inv2 * torch.sum(r * r, dim=-1) - norm

        full = lambda v: torch.full((1, 1), v, dtype=torch.float32, device=device)
        return TileDensityModel(
            logdensity_fn=loglik, dimension=n, logdensity_batched_fn=loglik, device=device,
            tile_density=gp_regression_tile, tile_consts=(col, full(inv2), full(norm)),
            cuda_density="gp_regression")

    def loglik(f):
        t = -y_t * f
        return -torch.sum(torch.logaddexp(torch.zeros_like(t), t), dim=-1)

    return TileDensityModel(
        logdensity_fn=loglik, dimension=n, logdensity_batched_fn=loglik, device=device,
        tile_density=gp_classification_tile, tile_consts=(col,),
        cuda_density="gp_classification")


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


# ---- likelihoods of the evidence estimators ---------------------------------


def normal_mean_tile(th: torch.Tensor, y: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Tile log-likelihood of n observations ``y`` (n, 1) from N(θ, σ²), θ the
    (1, C) row and ``sigma`` (1, 1):

        Σᵢ (−½zᵢ)·zᵢ − n·(log σ + ½log 2π),  zᵢ = (yᵢ − θ)/σ,

    the observations summed in order, as ``NormalMean`` in csrc/common.cuh."""
    z = (y - th) / sigma
    return row_sum(-0.5 * z * z) - y.shape[0] * (torch.log(sigma) + _HALF_LOG_2PI)


def normal_mean_likelihood(y, sigma: float, device="cuda") -> TileDensityModel:
    """The likelihood of the conjugate Normal-mean model: x = (θ,) and
    log L(θ) = Σᵢ log N(yᵢ; θ, σ) (the JAX evidence tests' ``jnp.sum(
    Normal(theta[0], sigma).log_prob(y))``). Under a N(0, τ²) prior the
    evidence has the closed form log N(y; 0, σ²I + τ²11ᵀ). Params are a
    scalar or a length-1 vector; the batched density takes (C,) or (C, 1)."""
    y_t = torch.as_tensor(np.asarray(y, np.float32), device=device)
    col = y_t.reshape(-1, 1)
    sig = torch.full((1, 1), float(sigma), dtype=torch.float32, device=device)

    def batched(th):
        return normal_mean_tile(th.reshape(1, -1), col, sig)[0]

    return TileDensityModel(
        logdensity_fn=lambda th: batched(th.reshape(1))[0], dimension=1,
        logdensity_batched_fn=batched, device=device, tile_density=normal_mean_tile,
        tile_consts=(col, sig), cuda_density="normal_mean")


def flat_tile(x: torch.Tensor) -> torch.Tensor:
    """Tile log-likelihood of the flat likelihood: zeros (1, C)."""
    return torch.zeros((1, x.shape[1]), dtype=torch.float32, device=x.device)


def flat_likelihood(d: int, device="cuda") -> TileDensityModel:
    """The flat likelihood L ≡ 1 over d parameters (the JAX evidence tests'
    ``lambda th: jnp.zeros(())``): under any proper prior the evidence is
    exactly 1, log Z = 0. ``Flat<D>`` in csrc/common.cuh."""

    def batched(th):
        return torch.zeros(th.shape[0], dtype=torch.float32, device=th.device)

    return TileDensityModel(
        logdensity_fn=lambda th: torch.zeros((), dtype=torch.float32, device=device),
        dimension=d, logdensity_batched_fn=batched, device=device, tile_density=flat_tile,
        cuda_density="flat")


# ---- the two-mode mixture (a check target of the tempering kernel) ----------

_BIMODAL_CONST = math.log(2.0) + _HALF_LOG_2PI


def bimodal_mixture_tile(x: torch.Tensor) -> torch.Tensor:
    """Tile density of ½N(−5, 1) + ½N(5, 1), x (1, C): with
    a = −½(x + 5)², b = −½(x − 5)² and m = max(a, b) (NaN kept),
    ``(m + log(exp(a − m) + exp(b − m))) − (log 2 + ½log 2π)`` (the constant
    rounded once), the JAX card test's manual logsumexp;
    ``BimodalMixture`` in csrc/common.cuh does the same."""
    ta, tb = x + 5.0, x - 5.0
    a, b = -0.5 * (ta * ta), -0.5 * (tb * tb)
    m = torch.maximum(a, b)
    return (m + torch.log(torch.exp(a - m) + torch.exp(b - m))) - _BIMODAL_CONST


def bimodal_mixture_model(device="cuda") -> TileDensityModel:
    """The equal mixture of N(−5, 1) and N(+5, 1) in one dimension, modes 8σ
    apart (≙ tests/test_pallas.py::TestFusedTempering._bimodal_model of the
    JAX package): the target on which a random walk stays in its starting
    mode and replica exchange hops between them. Params are a scalar or a
    length-1 vector; the batched density takes (C,) or (C, 1)."""

    def batched(x):
        return bimodal_mixture_tile(x.reshape(1, -1))[0]

    return TileDensityModel(
        logdensity_fn=lambda x: batched(x.reshape(1))[0], dimension=1,
        logdensity_batched_fn=batched, device=device, tile_density=bimodal_mixture_tile,
        cuda_density="bimodal_mixture")
