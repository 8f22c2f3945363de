"""Chain-summed autocovariance over a window of lags: the CUDA kernel's
wrapper and its plain version.

No Pallas counterpart: the JAX package computes ESS with plain ``jnp``.
``csrc/autocov.cu`` computes, for draws ``x`` (N, C) and chain means ``m``
(C,), the sums ``S_k = Σ_c Σ_{t<N−k} (x[t,c] − m_c)(x[t+k,c] − m_c)`` for
lags k < K (``N · C · mean_c acov[k, c]`` of the FFT path, in exact
arithmetic).

:func:`autocov_window` runs :func:`autocov_window_reference` for tensors on
the CPU, and for CUDA tensors launches the kernel or raises.
``autocov_window.launches`` counts the launches.

:func:`window_rho` turns the sums into the chain-averaged autocorrelations
and :func:`geyer_tau` those into τ and whether the window decides it: the one
statement of that rule for ``diagnostics/ess.py`` and the plain version of
``ops/summary.py``'s finish (``csrc/summary.cu`` states it again in CUDA).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

# csrc/autocov.cu: 16 lags a warp, at most 16 warps a block.
MAX_LAGS = 256


def _check(x: torch.Tensor, means: torch.Tensor, K: int) -> None:
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError("x must be a float32 (N, C) tensor")
    n, c = x.shape
    if n < 1 or c < 1:
        raise ValueError("x needs at least one draw of one chain")
    if tuple(means.shape) != (c,) or means.dtype != torch.float32:
        raise ValueError(f"means must be a float32 ({c},) tensor")
    if means.device != x.device:
        raise ValueError("x and means must be on one device")
    if not 1 <= K <= MAX_LAGS:
        raise ValueError(f"K must lie in [1, {MAX_LAGS}], got {K}")


def autocov_window_reference(x: torch.Tensor, means: torch.Tensor, K: int) -> torch.Tensor:
    """``S_k`` for k < min(K, N) as float64: each lag's products of the
    centred draws in float32, summed in float64."""
    n = x.shape[0]
    y = x - means
    return torch.stack([torch.sum(y[: n - k] * y[k:], dtype=torch.float64)
                        for k in range(min(K, n))])


def autocov_window(x: torch.Tensor, means: torch.Tensor, K: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``S_k`` for k < min(K, N) as a float64 vector, in one launch on the
    card (``x`` with contiguous chains, any row stride: the (N, C) view
    ``Chains.values[:, i, :]`` is read where it lies), written into ``out``
    where it is given (a contiguous float64 vector of min(K, N), on ``x``'s
    device: a row of the (P, K) sums of ``diagnostics/ess.py::window_sums``)."""
    _check(x, means, K)
    n, c = x.shape
    K = min(K, n)
    f64 = dict(dtype=torch.float64, device=x.device)
    if out is None:
        out = torch.empty(K, **f64)
    elif (tuple(out.shape) != (K,) or out.dtype != torch.float64 or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float64 ({K},) tensor on x's device")
    if x.device.type == "cpu":
        return out.copy_(autocov_window_reference(x, means, K))
    if c > 1 and x.stride(1) != 1:
        raise ValueError("x must hold its chains contiguously (stride 1 on dim 1)")
    partials = torch.empty((K, _build.library().amh_autocov_blocks(n, c)), **f64)
    _build.launch("amh_autocov_window", "autocov", None, 0, x.device, x, x.stride(0),
                  means.contiguous(), n, c, K, partials, out)
    autocov_window.launches += 1
    return out


autocov_window.launches = 0


def window_rho(sums: torch.Tensor, means: torch.Tensor, n: int) -> torch.Tensor:
    """The chain-averaged autocorrelations at the lags of ``sums`` (K,), the
    float64 sums ``S_k`` of ``n`` draws of each chain centred on the chains'
    means ``means`` (C,): Vehtari et al.'s var⁺, with the chain means'
    variance where C > 1."""
    c = means.shape[0]
    acov = sums / (n * c)  # mean over chains
    mean_var = acov[0] * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + torch.var(means.double(), correction=1)
    return 1.0 - (mean_var - acov) / var_plus


def geyer_tau(rho: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """τ of ``n`` draws from the autocorrelations ``rho`` at their first lags,
    by Geyer's paired sums, and whether those lags decide it: true where the
    sums' running min is not positive (NaN included) by the last pair, so
    that every pair past it adds 0, or where ``rho`` holds every pair."""
    # Paired sums, monotone by running min; the first non-positive pair
    # truncates everything after it. A NaN pair sum (draws constant in every
    # chain) counts as 0, as in JAX, so τ takes its floor.
    n_pairs = min(n // 2, rho.shape[0] // 2)
    pair_sums = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs : 2]
    pair_sums = torch.cummin(pair_sums, dim=0).values
    tau = 2.0 * torch.sum(torch.where(pair_sums > 0, pair_sums, 0.0)) - 1.0
    if 2 * (n // 2) <= rho.shape[0]:
        decided = torch.ones((), dtype=torch.bool, device=rho.device)
    else:
        decided = ~(pair_sums[-1] > 0)
    return torch.clamp(tau, min=1e-6), decided
