"""Every statistic of ``Chains.summary()`` from one pass over the draws: the
CUDA kernels' wrappers and their plain versions.

No Pallas counterpart: the JAX package computes its summary with plain
``jnp``. ``csrc/summary.cu`` has two kernels:

- :func:`chain_moments`: for draws ``values`` (N, P, C), each parameter's
  and chain's sum and centred second moment of three row ranges, the first
  half ``[0, h)``, the second ``[h, 2h)`` and the odd last row ``[2h, N)``
  (h = N // 2, R̂'s split; their counts, the same for every chain, are
  :func:`range_counts`), as ``moments`` (P, 3, 2, C) float64, and each
  chain's float32 mean over all N rows, which ``ops/autocov.py`` centres
  the lag window with;
- :func:`summary_finish`: from those and each parameter's lag-window sums
  (P, K) the (P, 7) float64 table of :data:`COLUMNS`: mean, std
  (correction 0), naive_se, ESS (``diagnostics/ess.py``'s window), mcse =
  std / √ESS, split-chain R̂, and whether the window decided the ESS.

Each wrapper runs its plain version for tensors on the CPU and for CUDA
tensors launches its kernel or raises; ``<wrapper>.launches`` counts the
launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.trace import traced
from . import _build
from .autocov import geyer_tau, window_rho

COLUMNS = ("mean", "std", "naive_se", "ess", "mcse", "rhat", "decided")
# csrc/summary.cu: one lag a thread of a finishing block's first 256
MAX_LAGS = 256


def range_counts(n: int) -> Tuple[int, int, int]:
    """Rows of the three ranges of ``moments``: both halves and the odd row."""
    h = n // 2
    return h, h, n - 2 * h


def _check_values(values: torch.Tensor) -> None:
    if values.ndim != 3 or values.dtype != torch.float32:
        raise ValueError("values must be a float32 (N, P, C) tensor")
    if min(values.shape) < 1:
        raise ValueError("values needs at least one draw of one parameter of one chain")


def chain_moments_reference(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moments`` (P, 3, 2, C) and ``means`` (P, C): each range's sum and
    its second moment about the range's mean, in float64 (an empty range
    gives 0 and 0), and the float32 of the sum of all rows over N."""
    n, p, c = values.shape
    h = n // 2
    x = values.double()
    moments = torch.zeros((p, 3, 2, c), dtype=torch.float64, device=values.device)
    for r, rows in enumerate((x[:h], x[h:2 * h], x[2 * h:])):
        if rows.shape[0]:
            total = torch.sum(rows, dim=0)
            moments[:, r, 0] = total
            moments[:, r, 1] = torch.sum((rows - total / rows.shape[0]) ** 2, dim=0)
    means = (torch.sum(moments[:, :, 0], dim=1) / n).to(torch.float32)
    return moments, means


@traced("kernel.chain_moments")
def chain_moments(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moments`` and ``means`` of float32 draws ``values`` (N, P, C), in one
    launch on the card (any row and parameter stride, chains contiguous:
    ``Chains.values`` is read where it lies)."""
    _check_values(values)
    if values.device.type == "cpu":
        return chain_moments_reference(values)
    n, p, c = values.shape
    if c > 1 and values.stride(2) != 1:
        raise ValueError("values must hold its chains contiguously (stride 1 on dim 2)")
    moments = torch.empty((p, 3, 2, c), dtype=torch.float64, device=values.device)
    means = torch.empty((p, c), dtype=torch.float32, device=values.device)
    _build.launch("amh_chain_moments", "summary", None, 0, values.device, values,
                  values.stride(0), values.stride(1), n, p, c, moments, means)
    chain_moments.launches += 1
    return moments, means


chain_moments.launches = 0


def _check_finish(moments: torch.Tensor, means: torch.Tensor, acov: torch.Tensor,
                  n: int) -> None:
    p, c = means.shape
    if tuple(moments.shape) != (p, 3, 2, c) or moments.dtype != torch.float64:
        raise ValueError(f"moments must be a float64 ({p}, 3, 2, {c}) tensor")
    if means.dtype != torch.float32:
        raise ValueError("means must be float32")
    if (acov.ndim != 2 or acov.shape[0] != p or acov.dtype != torch.float64
            or not 1 <= acov.shape[1] <= min(n, MAX_LAGS)):
        raise ValueError(f"acov must be a float64 ({p}, K) tensor, 1 <= K <= min(N, {MAX_LAGS})")
    if not moments.device == means.device == acov.device:
        raise ValueError("moments, means and acov must be on one device")


def summary_finish_reference(moments: torch.Tensor, means: torch.Tensor, acov: torch.Tensor,
                             n: int) -> torch.Tensor:
    """The (P, 7) table of :data:`COLUMNS` in float64, by the formulas of
    the per-statistic path of ``Chains.summary()``; ESS by the window's rule
    (``ops/autocov.py``: :func:`window_rho`, :func:`geyer_tau`)."""
    p, _, _, c = moments.shape
    h, _, n2 = range_counts(n)
    nc = n * c
    sums, m2 = moments[:, :, 0], moments[:, :, 1]  # (P, 3, C)
    h64 = torch.tensor(float(h), dtype=torch.float64, device=moments.device)
    half_means = sums[:, :2] * (1.0 / h64)  # (P, 2, C): R̂'s 2C half-chains
    grand = torch.sum(sums, dim=(1, 2)) / nc
    second = torch.zeros(p, dtype=torch.float64, device=moments.device)
    for r, count in enumerate((h, h, n2)):
        if count:
            dev = (half_means[:, r] if r < 2 else sums[:, r]) - grand[:, None]
            second = second + torch.sum(m2[:, r] + count * dev * dev, dim=1)
    std = torch.sqrt(second / nc)

    within = torch.mean(m2[:, :2] * (1.0 / (h64 - 1.0)), dim=(1, 2))
    between = h64 * torch.var(half_means.reshape(p, -1), dim=1, correction=1)
    rhat = torch.sqrt(((h64 - 1.0) / h64 * within + between / h64) / within)

    rows = []
    for i in range(p):
        tau, decided = geyer_tau(window_rho(acov[i], means[i], n), n)
        ess = (nc / tau).to(torch.float32).double()
        rows.append(torch.stack([grand[i], std[i], std[i] / nc ** 0.5, ess,
                                 std[i] / torch.sqrt(ess), rhat[i], decided.double()]))
    return torch.stack(rows)


@traced("kernel.summary_finish")
def summary_finish(moments: torch.Tensor, means: torch.Tensor, acov: torch.Tensor,
                   n: int) -> torch.Tensor:
    """The (P, 7) float64 table of :data:`COLUMNS` for draws of ``n`` rows,
    in one launch on the card (one block a parameter)."""
    _check_finish(moments, means, acov, n)
    if moments.device.type == "cpu":
        return summary_finish_reference(moments, means, acov, n)
    p, c = means.shape
    out = torch.empty((p, len(COLUMNS)), dtype=torch.float64, device=moments.device)
    _build.launch("amh_summary_finish", "summary", None, 0, moments.device,
                  moments.contiguous(), means.contiguous(), acov.contiguous(), n, p, c,
                  acov.shape[1], out)
    summary_finish.launches += 1
    return out


summary_finish.launches = 0
