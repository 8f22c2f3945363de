"""Chain-summed autocovariance over a window of lags: the CUDA kernel's
wrapper and its plain version.

No Pallas counterpart: the JAX package computes ESS with plain ``jnp``.
``csrc/autocov.cu`` computes, for draws ``x`` (N, C) and chain means ``m``
(C,), the sums ``S_k = Σ_c Σ_{t<N−k} (x[t,c] − m_c)(x[t+k,c] − m_c)`` for
lags k < K, which ``diagnostics/ess.py`` turns into Geyer's sequence
(``N · C · mean_c acov[k, c]`` of the FFT path, in exact arithmetic).

:func:`autocov_window` runs :func:`autocov_window_reference` for tensors on
the CPU, and for CUDA tensors launches the kernel or raises.
``autocov_window.launches`` counts the launches.
"""
from __future__ import annotations

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


def autocov_window(x: torch.Tensor, means: torch.Tensor, K: int) -> torch.Tensor:
    """``S_k`` for k < min(K, N) as a float64 vector, in one launch on the
    card (``x`` with contiguous chains, any row stride: the (N, C) view
    ``Chains.values[:, i, :]`` is read where it lies)."""
    _check(x, means, K)
    if x.device.type == "cpu":
        return autocov_window_reference(x, means, K)
    n, c = x.shape
    if c > 1 and x.stride(1) != 1:
        raise ValueError("x must hold its chains contiguously (stride 1 on dim 1)")
    K = min(K, n)
    f64 = dict(dtype=torch.float64, device=x.device)
    partials = torch.empty((K, _build.library().amh_autocov_blocks(n, c)), **f64)
    out = torch.empty(K, **f64)
    _build.launch("amh_autocov_window", "autocov", None, 0, x.device, x, x.stride(0),
                  means.contiguous(), n, c, K, partials, out)
    autocov_window.launches += 1
    return out


autocov_window.launches = 0
