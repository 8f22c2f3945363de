"""Effective sample size, split-R̂ and MCSE (≙ advancedmh_tpu/diagnostics/ess.py).

FFT autocovariance over the whole (draws × chains) batch on the draws'
device. ESS follows Vehtari et al. 2021: Geyer's initial monotone positive
sequence over chain-averaged autocorrelations; R̂ is the split-chain
potential scale reduction; the rank-normalized variants replace draws by
normal quantiles of their pooled ranks first.
"""
from __future__ import annotations

import torch


def _as_2d(x: torch.Tensor) -> torch.Tensor:
    return x[:, None] if x.ndim == 1 else x


def _autocov(x: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance per chain via FFT. x: (N, C) -> (N, C)."""
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True)
    nfft = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(xc, n=nfft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=0)[:n]
    return acov / n


def ess(x: torch.Tensor) -> torch.Tensor:
    """Effective sample size of draws ``x`` shaped (N,) or (N, C),
    aggregated over chains."""
    x = _as_2d(x)
    n, c = x.shape
    acov = _autocov(x)
    mean_var = torch.mean(acov[0]) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + torch.var(torch.mean(x, dim=0), correction=1)
    rho = 1.0 - (mean_var - torch.mean(acov, dim=1)) / var_plus
    # Geyer: paired sums, monotone by running min; the first non-positive
    # pair truncates everything after it. A NaN pair sum (draws constant in
    # every chain) counts as 0, as in JAX, so τ takes its floor.
    n_pairs = n // 2
    pair_sums = rho[0 : 2 * n_pairs : 2] + rho[1 : 2 * n_pairs : 2]
    pair_sums = torch.cummin(pair_sums, dim=0).values
    tau = 2.0 * torch.sum(torch.where(pair_sums > 0, pair_sums, 0.0)) - 1.0
    tau = torch.clamp(tau, min=1e-6)
    return n * c / tau


def rhat(x: torch.Tensor) -> torch.Tensor:
    """Split-chain R̂ of draws ``x`` shaped (N,) or (N, C)."""
    x = _as_2d(x)
    half = x.shape[0] // 2
    x = torch.cat([x[:half], x[half : 2 * half]], dim=1)
    n = x.shape[0]
    chain_means = torch.mean(x, dim=0)
    chain_vars = torch.var(x, dim=0, correction=1)
    between = n * torch.var(chain_means, correction=1)
    within = torch.mean(chain_vars)
    var_plus = (n - 1.0) / n * within + between / n
    return torch.sqrt(var_plus / within)


def mcse(x: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo standard error of the mean via ESS."""
    x = _as_2d(x)
    return torch.std(x, correction=0) / torch.sqrt(ess(x))


def _quantile(x: torch.Tensor, prob: float) -> torch.Tensor:
    """Linear-interpolation quantile over all elements (numpy's default);
    by sorting, so it has no size limit."""
    flat = torch.sort(x.reshape(-1)).values
    pos = prob * (flat.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, flat.numel() - 1)
    return flat[lo] + (flat[hi] - flat[lo]) * (pos - lo)


def _rank_normalize(x: torch.Tensor) -> torch.Tensor:
    """Pooled ranks → standard-normal quantiles, x: (N, C). Blom offset
    (r − 3/8)/(S + 1/4). Tied draws (an MH chain repeats its state on every
    rejection) take their ranks in order of position, as JAX's stable
    argsort gives them."""
    n, c = x.shape
    s = n * c
    flat = x.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ranks = torch.empty_like(flat).scatter_(
        0, order, torch.arange(1, s + 1, dtype=x.dtype, device=x.device)
    )
    p = (ranks - 0.375) / (s + 0.25)
    # float32 guard: above 2²⁴ draws the top fractional ranks round to 1.0
    # and Φ⁻¹ gives +inf, which poisons the FFT autocovariance (the
    # 4000 × 16384 main-path batch reaches it). Clip into the widest open
    # interval float32 resolves around (0, 1).
    tiny = 1.5e-7
    z = torch.special.ndtri(torch.clamp(p, tiny, 1.0 - tiny))
    return z.reshape(n, c)


def ess_bulk(x: torch.Tensor) -> torch.Tensor:
    """Bulk ESS: ESS of the rank-normalized draws (Vehtari 2021 eq. 14)."""
    return ess(_rank_normalize(_as_2d(x)))


def ess_tail(x: torch.Tensor, prob: float = 0.05) -> torch.Tensor:
    """Tail ESS: min ESS of the {prob, 1−prob} quantile indicators."""
    x = _as_2d(x)
    lo = _quantile(x, prob)
    hi = _quantile(x, 1.0 - prob)
    e_lo = ess((x <= lo).to(torch.float32))
    e_hi = ess((x >= hi).to(torch.float32))
    return torch.minimum(e_lo, e_hi)


def rhat_rank(x: torch.Tensor) -> torch.Tensor:
    """Rank-normalized split-R̂: max over the draws and the folded draws
    |x − median| (Vehtari 2021 §4.2)."""
    x = _as_2d(x)
    bulk = rhat(_rank_normalize(x))
    folded = rhat(_rank_normalize(torch.abs(x - _quantile(x, 0.5))))
    return torch.maximum(bulk, folded)
