"""Plain ``Chains.summary()``: per parameter the mean, std, naive_se, mcse,
ess and rhat of its draws (N, C).

Copied from ``advancedmh_tpu_torch/output/chains.py::Chains.summary`` and
``diagnostics/ess.py::_autocov, ess, rhat, mcse`` (commit 63ce544): the
FFT autocovariance per chain, Geyer's initial monotone positive sequence
over the chain-averaged autocorrelations (a NaN pair sum counts as 0), τ
floored at 1e-6, ESS = N·C/τ; split-chain R̂; mcse = std/√ESS. The
arithmetic runs in ``dtype``; in bfloat16 the FFT, which PyTorch has no
bfloat16 form of, runs in float32 on bfloat16 inputs and its output is
rounded to bfloat16. Plain PyTorch; imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict

import torch


def _autocov(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    nfft = 1 << (2 * n - 1).bit_length()
    fft_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    f = torch.fft.rfft(xc.to(fft_dtype), n=nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:n]
    return (acov / n).to(x.dtype)


def ess(x: torch.Tensor) -> torch.Tensor:
    n, c = x.shape
    acov = _autocov(x)
    mean_var = torch.mean(acov[0]) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + torch.var(torch.mean(x, dim=0), correction=1)
    rho = 1.0 - (mean_var - torch.mean(acov, dim=1)) / var_plus
    n_pairs = n // 2
    pair_sums = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    pair_sums = torch.cummin(pair_sums, dim=0).values
    tau = 2.0 * torch.sum(torch.where(pair_sums > 0, pair_sums, 0.0)) - 1.0
    tau = torch.clamp(tau, min=1e-6)
    return n * c / tau


def rhat(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[0] // 2
    x = torch.cat([x[:half], x[half:2 * half]], dim=1)
    n = x.shape[0]
    within = torch.mean(torch.var(x, dim=0, correction=1))
    between = n * torch.var(torch.mean(x, dim=0), correction=1)
    var_plus = (n - 1.0) / n * within + between / n
    return torch.sqrt(var_plus / within)


def summarize(values: torch.Tensor, names, dtype=torch.float64) -> Dict[str, Dict[str, float]]:
    """The statistics of draws ``values`` (N, P, C), one parameter at a time
    in ``dtype``."""
    out = {}
    for i, name in enumerate(names):
        x = values[:, i, :].to(dtype)
        n_total = x.shape[0] * x.shape[1]
        std = torch.std(x, correction=0)
        e = ess(x)
        out[name] = {
            "mean": float(torch.mean(x)),
            "std": float(std),
            "naive_se": float(std) / n_total ** 0.5,
            "mcse": float(std / torch.sqrt(e)),
            "ess": float(e),
            "rhat": float(rhat(x)),
        }
    return out
