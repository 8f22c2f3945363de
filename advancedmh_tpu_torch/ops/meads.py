"""Fused MEADS: the CUDA kernel's wrapper and its plain version.

≙ advancedmh_tpu/ops/pallas_meads.py. The kernel (``csrc/meads.cu``) runs
the whole warmup-free sampler: ``burn`` steps, then ``n_samples`` thinned
draws; sample e is the state after ``burn + (e+1)·thin`` steps. The chains
form independent ensembles of ``tile_chains`` (the last one may be short),
each split into K contiguous folds of F = size/K chains. In a step the folds
move one after another; fold k is tuned by fold b = (k − 1) mod K's current
state:

- σ = max(√(Σ(x − μ)²/F), 1e-10) per coordinate (two passes, μ = Σx/F; 1
  without ``diagonal_preconditioning``);
- λ̂ = tr(A²)/tr(A) of σ∘g and of (x − μ)/σ (:func:`max_eig_cols`);
- ε = min(mult/√max(λ̂_g, 1e-30), clip), γ = max(1/√max(λ̂_x, 1),
  slowdown/(ε·(t + 1))), α = 1 − exp(−2εγ), δ = α/2;

then each chain of fold k takes one GHMC step: p₁ = √(1−α)·p + √α·z, one
leapfrog step in σ-preconditioned space, logα from the energy error, the
acceptance probability a (0 where ``|logα| < 1e30`` fails); the
nonreversible slice accepts iff u < a and renews u (``u/a`` or
``(u − a)/(1 − a)``, floors 1e-30, then ``+ δ`` wrapped by a select), the
Metropolis variant iff ``-log u' > -logα``; a rejection negates p.

Step t (the iteration, ``t0`` for the launch's first) draws z and u' from
Philox at counter (t, chain) (ops/common.py::step_noise), so a run split at
any step and resumed from its final state is exact. A tile runs in one
cluster of :func:`cluster_ctas` blocks, block r holding fold positions
[r·P, r·P + P) of every fold (:func:`cta_chains`), and the pooled sums run in
the kernel's order: each block's positions in order, then the blocks in order
(ops/pooling.py::cluster_sum). The wrapper runs the plain version for tensors
on the CPU, and for CUDA tensors launches the kernel or raises;
``fused_meads_sample.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.trace import traced
from . import _build
from .common import f32, noise_chunk, row_sum, step_noise
from .pooling import cluster_sum, full, nan_max, nan_min, tile_groups, tree_sum

_TINY = 1e-30
MEADS_THREADS = 256  # threads a block (csrc/meads.cu::kMeadsThreads), 8 warps
MAX_CLUSTER = 16  # blocks a cluster (kMaxCluster): the card's non-portable limit
CTA_POSITIONS = 32  # fold positions a block aims at: 32 chains x 8 lanes, d = 32


def cluster_ctas(tile_chains: int, n_folds: int) -> int:
    """Blocks of a tile's cluster: ceil(F / 32) for F = tile_chains // n_folds
    fold positions, rounded up to a power of two, at most 16. One number for
    the launch (a short last tile takes as many, some with no positions)."""
    want = -(-(tile_chains // n_folds) // CTA_POSITIONS)
    n = 1
    while n < min(want, MAX_CLUSTER):
        n *= 2
    return n


def cta_chains(n_chains: int, tile_chains: int, n_folds: int):
    """(blocks a cluster, chains (blocks, n_folds, P) of each block of the
    launch in block order): block b runs tile b // n_cta, whose fold k holds
    chains start + k·F + j; block rank r takes positions j in [r·P, r·P + P),
    P = ceil(F / n_cta), and −1 marks a position past F (or past a short
    tile's P)."""
    K = n_folds
    n_cta = cluster_ctas(tile_chains, K)
    blocks = []
    for start, n_t, size in tile_groups(n_chains, tile_chains):
        F_ = size // K
        P = -(-F_ // n_cta)
        pos = torch.arange(n_cta)[:, None] * P + torch.arange(P)  # (n_cta, P)
        chains = (start + torch.arange(n_t)[:, None, None, None] * size
                  + torch.arange(K)[None, None, :, None] * F_ + pos[None, :, None, :])
        chains = torch.where((pos < F_)[None, :, None, :], chains, -1)
        blocks.append(chains.reshape(n_t * n_cta, K, P))
    P_max = max(b.shape[-1] for b in blocks)
    return n_cta, torch.cat([F.pad(b, (0, P_max - b.shape[-1]), value=-1) for b in blocks])


def max_eig_cols(v: torch.Tensor) -> torch.Tensor:
    """Soft maximum eigenvalue of A = E[v vᵀ] over the F columns of ``v``
    (d, F): tr(A²)/tr(A) with the unbiased i≠j pair estimate of tr(A²)
    (Hoffman-Sountsov 2022 §3.1; ≙ pallas_meads.py::_max_eig_cols), in plain
    float32 (no TF32)."""
    F_ = v.shape[1]
    colnorm2 = torch.sum(v * v, dim=0)
    tr_a = torch.sum(colnorm2) / F_
    G = torch.matmul(v, v.T)
    tr_a2 = (torch.sum(G * G) - torch.sum(colnorm2 * colnorm2)) / (F_ * (F_ - 1.0))
    return tr_a2 / nan_max(tr_a, _TINY)


def pooled_max_eig(v: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """:func:`max_eig_cols` of each fold ``v`` (n, d, F) in the kernel's
    order: the Gram matrix and the column norms (each over the coordinates in
    order) summed over the F chains by :func:`cluster_sum` with ``n_blocks``
    blocks; then Σ G² with entry e taken by thread e mod MEADS_THREADS in
    order, a tree over each warp's 32 threads and a tree over the warps."""
    n, d, F_ = v.shape
    colnorm2 = row_sum(v.transpose(0, 1) * v.transpose(0, 1))[0]  # (n, F)
    prods = (v[:, :, None, :] * v[:, None, :, :]).reshape(n, d * d, F_)
    sums = cluster_sum(torch.cat([prods, colnorm2[:, None], (colnorm2 * colnorm2)[:, None]], 1),
                       n_blocks)
    gram, sc, sc2 = sums[:, :d * d], sums[:, d * d], sums[:, d * d + 1]
    T = MEADS_THREADS
    m = -(-d * d // T)
    sq = F.pad(gram * gram, (0, m * T - d * d)).reshape(n, m, T)
    acc = torch.zeros((n, T), dtype=v.dtype, device=v.device)
    for i in range(m):
        acc = acc + sq[:, i]
    s_gg = tree_sum(tree_sum(acc.reshape(n, T // 32, 32)))
    tr_a = sc / full(sc, float(F_))
    tr_a2 = (s_gg - sc2) / full(s_gg, f32(F_ * (F_ - 1.0)))
    return tr_a2 / nan_max(tr_a, _TINY)


@dataclasses.dataclass(frozen=True)
class MeadsParams:
    """The kernel's sampler constants, rounded to float32."""

    step_size_multiplier: float = 0.5
    step_size_clip: float = 1.0
    damping_slowdown: float = 1.0
    diagonal_preconditioning: bool = True
    accept: str = "nonreversible"

    def __post_init__(self):
        for name in ("step_size_multiplier", "step_size_clip", "damping_slowdown"):
            object.__setattr__(self, name, f32(getattr(self, name)))

    @classmethod
    def of(cls, sampler) -> "MeadsParams":
        return cls(sampler.step_size_multiplier, sampler.step_size_clip,
                   sampler.damping_slowdown, sampler.diagonal_preconditioning,
                   sampler.accept)


def fold_parameters(xb: torch.Tensor, gb: torch.Tensor, t: int, prm: MeadsParams,
                    n_blocks: int):
    """(σ (n, d), ε, α, δ (n,)) of the folds ``xb``, ``gb`` (n, d, F) at
    iteration ``t``, in the kernel's order with ``n_blocks`` blocks a
    cluster."""
    F_ = xb.shape[2]
    mu = cluster_sum(xb, n_blocks) / full(xb[:, :, 0], float(F_))
    xc = xb - mu[..., None]
    if prm.diagonal_preconditioning:
        var = cluster_sum(xc * xc, n_blocks) / full(mu, float(F_))
        sigma = nan_max(torch.sqrt(var), f32(1e-10))
    else:
        sigma = torch.ones_like(mu)
    lam_g = pooled_max_eig(sigma[..., None] * gb, n_blocks)
    lam_x = pooled_max_eig(xc / sigma[..., None], n_blocks)
    eps = prm.step_size_multiplier * (1.0 / torch.sqrt(nan_max(lam_g, _TINY)))
    eps = nan_min(eps, prm.step_size_clip)
    gamma = 1.0 / torch.sqrt(nan_max(lam_x, 1.0))
    gamma = nan_max(gamma, full(eps, prm.damping_slowdown) / (eps * f32(t + 1.0)))
    alpha = 1.0 - torch.exp(-2.0 * eps * gamma)
    return sigma, eps, alpha, 0.5 * alpha


def ghmc_move(xk, lpk, gk, pk, uk, z, logu, sigma, eps, alpha, delta, value_and_grad,
              consts, nonreversible: bool):
    """One GHMC step of chains (d, n) with per-chain parameters (σ (d, n);
    ε, α, δ (1, n)): returns (x, lp, g, p, u, accepted)."""
    p1 = torch.sqrt(1.0 - alpha) * pk + torch.sqrt(alpha) * z
    half = 0.5 * eps
    ph = p1 + half * (sigma * gk)
    y = xk + eps * (sigma * ph)
    lp_y, g_y = value_and_grad(y, *consts)
    p2 = ph + half * (sigma * g_y)
    ke1 = 0.5 * row_sum(p1 * p1)
    ke2 = 0.5 * row_sum(p2 * p2)
    logalpha = (lp_y - ke2) - (lpk - ke1)
    a = torch.where(torch.abs(logalpha) < 1e30, torch.exp(nan_min(logalpha, 0.0)),
                    torch.zeros_like(logalpha))
    if nonreversible:
        acc = uk < a
        u_new = torch.where(acc, uk / nan_max(a, _TINY), (uk - a) / nan_max(1.0 - a, _TINY))
        v = u_new + delta
        u_next = torch.where(v >= 1.0, v - 1.0, v)
    else:
        acc = -logu[None] > -logalpha
        u_next = uk
    return (torch.where(acc, y, xk), torch.where(acc, lp_y, lpk), torch.where(acc, g_y, gk),
            torch.where(acc, p2, -p1), u_next, acc)


def check_folds(n_chains: int, n_folds: int, tile_chains: int) -> None:
    """Every chain tile splits into n_folds folds of >= 2 chains."""
    sizes = [size for _, _, size in tile_groups(n_chains, tile_chains)]
    if n_folds < 2 or any(size % n_folds or size // n_folds < 2 for size in sizes):
        raise ValueError(
            f"MEADS needs every chain tile (tiles of {tile_chains} of the {n_chains} "
            f"chains) divisible by n_folds={n_folds} with >= 2 chains per fold"
        )


def meads_reference(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor, p: torch.Tensor,
    u: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, n_folds: int,
    t0: int, burn: int, thin: int, n_samples: int, params: MeadsParams,
    tile_chains: int,
):
    """Plain PyTorch version of the kernel (same signature and outputs as
    :func:`fused_meads_sample`; ``cuda_density`` is unused)."""
    d, C = params_t.shape
    K = n_folds
    dev = params_t.device
    f = dict(dtype=torch.float32, device=dev)
    samples = torch.empty((n_samples, d, C), **f)
    lps = torch.empty((n_samples, 1, C), **f)
    accs = torch.empty((n_samples, 1, C), **f)
    x, l, g, pp, uu = (t.clone() for t in (params_t, lp, grad, p, u))
    acc = torch.zeros((1, C), dtype=torch.bool, device=dev)
    nonrev = params.accept == "nonreversible"
    n_cta = cluster_ctas(tile_chains, K)
    folds = []  # per tile group: (n_t, F, chain index of fold k position j)
    for start, n_t, size in tile_groups(C, tile_chains):
        F_ = size // K
        base = start + torch.arange(n_t, device=dev)[:, None] * size
        folds.append((n_t, F_, [base + k * F_ + torch.arange(F_, device=dev) for k in range(K)]))
    n_steps = burn + n_samples * thin
    chunk = noise_chunk(C)
    for s0 in range(0, n_steps, chunk):
        n = min(chunk, n_steps - s0)
        z, logu = step_noise(seed, t0 + s0, n, C, d, dev)
        for i in range(n):
            s = s0 + i
            for k in range(K):
                b = (k - 1) % K
                for n_t, F_, idx in folds:
                    ib, ik = idx[b].reshape(-1), idx[k].reshape(-1)
                    xb = x[:, ib].reshape(d, n_t, F_).transpose(0, 1)
                    gb = g[:, ib].reshape(d, n_t, F_).transpose(0, 1)
                    sigma, eps, alpha, delta = fold_parameters(xb, gb, t0 + s, params, n_cta)
                    rep = lambda v: torch.repeat_interleave(v, F_, dim=-1)
                    out = ghmc_move(x[:, ik], l[:, ik], g[:, ik], pp[:, ik], uu[:, ik],
                                    z[i][:, ik], logu[i][ik], rep(sigma.T),
                                    rep(eps)[None], rep(alpha)[None], rep(delta)[None],
                                    value_and_grad, consts, nonrev)
                    x[:, ik], l[:, ik], g[:, ik], pp[:, ik], uu[:, ik], acc[:, ik] = out
            if s + 1 > burn and (s + 1 - burn) % thin == 0:
                e = (s + 1 - burn) // thin - 1
                samples[e], lps[e], accs[e] = x, l, acc.to(torch.float32)
    return samples, lps, accs, x, l, g, pp, uu


@traced("kernel.meads")
def fused_meads_sample(
    value_and_grad: Callable, cuda_density: Optional[str],
    params_t: torch.Tensor, lp: torch.Tensor, grad: torch.Tensor, p: torch.Tensor,
    u: torch.Tensor, consts: Sequence[torch.Tensor], seed: int, *, n_folds: int,
    t0: int, burn: int, thin: int, n_samples: int, params: MeadsParams = MeadsParams(),
    tile_chains: int,
):
    """Fused MEADS (≙ pallas_meads.py::fused_meads_sample).

    ``p`` (d, C) and ``u`` (1, C) are the persistent momentum and slice
    variable, ``t0`` the iteration of the first step (1 for a fresh run).
    Returns samples ``(n_samples, d, C)``, lps and accepted
    ``(n_samples, 1, C)`` (float32 0/1), and the final x, lp, gradient, p
    and u."""
    if params_t.ndim != 2 or params_t.dtype != torch.float32:
        raise ValueError("params_t must be a float32 (d, C) tensor")
    d, C = params_t.shape
    for name, t, shape in (("lp", lp, (1, C)), ("grad", grad, (d, C)), ("p", p, (d, C)),
                           ("u", u, (1, C))):
        if tuple(t.shape) != shape or t.device != params_t.device:
            raise ValueError(f"{name} must be {shape} on the params' device")
    if min(burn, thin - 1, n_samples - 1) < 0 or t0 < 0:
        raise ValueError("burn >= 0, thin >= 1, n_samples >= 1 and t0 >= 0 are required")
    check_folds(C, n_folds, tile_chains)
    if params.accept not in ("nonreversible", "metropolis"):
        raise ValueError(f"unknown accept {params.accept!r}")
    kw = dict(n_folds=n_folds, t0=t0, burn=burn, thin=thin, n_samples=n_samples,
              params=params, tile_chains=tile_chains)
    if params_t.device.type == "cpu":
        return meads_reference(value_and_grad, cuda_density, params_t, lp, grad, p, u,
                               consts, seed, **kw)
    _build.check_cuda_launch(params_t, seed, t0)
    dev = params_t.device
    flat, n_consts = _build.flat_consts(consts, dev)
    fl = dict(dtype=torch.float32, device=dev)
    # the state, updated in place by the kernel, on copies
    x_s, lp_s, g_s, p_s, u_s = (t.to(torch.float32, copy=True).contiguous()
                                for t in (params_t, lp, grad, p, u))
    samples = torch.empty((n_samples, d, C), **fl)
    lps = torch.empty((n_samples, 1, C), **fl)
    accs = torch.empty((n_samples, 1, C), **fl)
    _build.launch("amh_meads_sample", "meads", cuda_density, d, dev,
                  int(params.diagonal_preconditioning), int(params.accept == "nonreversible"),
                  x_s, lp_s, g_s, p_s, u_s, flat, n_consts, params.step_size_multiplier,
                  params.step_size_clip, params.damping_slowdown, n_folds, tile_chains, C,
                  cluster_ctas(tile_chains, n_folds), seed, t0, burn, thin, n_samples, samples,
                  lps, accs)
    fused_meads_sample.launches += 1
    return samples, lps, accs, x_s, lp_s, g_s, p_s, u_s


fused_meads_sample.launches = 0


def meads_launch_info(cuda_density: str, d: int, n_consts: int, n_chains: int, n_folds: int,
                      tile_chains: int, params: MeadsParams = MeadsParams()) -> dict:
    """The kernel's launch shape on the current card: blocks a cluster,
    blocks, threads a block, lanes a chain, dynamic shared memory bytes,
    whether the chains' state stays in shared memory, and the clusters the
    card holds at once (``cudaOccupancyMaxActiveClusters``; 0: the launch
    would be refused)."""
    lib = _build.library()
    out = (ctypes.c_int64 * 7)()
    code = lib.amh_meads_info(_build.density_arg(cuda_density), d,
                              int(params.diagonal_preconditioning),
                              int(params.accept == "nonreversible"), n_consts, n_folds,
                              tile_chains, n_chains, cluster_ctas(tile_chains, n_folds),
                              ctypes.addressof(out))
    _build.check(lib, code, "meads", cuda_density, d)
    keys = ("cluster", "blocks", "threads", "lanes_per_chain", "smem_bytes", "state_shared",
            "active_clusters")
    return dict(zip(keys, map(int, out)))
