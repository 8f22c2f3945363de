"""Marginal-likelihood (evidence) estimation via power posteriors.

≙ advancedmh_tpu/runtime/evidence.py. The power-posterior family tempers the
**likelihood only** (Friel-Pettitt 2008):

    π_β(x) ∝ p(x) · L(x)^β,     Z(0) = 1 (proper prior),  Z(1) = evidence

and two estimators come from the same ladder run (a third, AIS, sweeps the
ladder instead; see :func:`log_evidence_ais`):

- **Thermodynamic integration**: log Z = ∫₀¹ E_β[log L] dβ, trapezoid over
  the rungs.
- **Stepping-stone** (Xie et al. 2011): log Z = Σ_k log E_{β_k}[
  L^{β_{k+1}−β_k} ], each expectation a logsumexp over that rung's draws,
  with a delta-method standard error ``se_ss`` from the spread of the
  independent chains' per-rung estimates.

The whole ladder runs as ONE flat chain batch: rung k holds ``num_chains``
chains with its β, so K rungs × C chains are one batched RWMH on the torch
engine (``engine="torch"``, a loop of tensor steps, ``power_step``) or one
launch of the hand-written CUDA kernel (``engine="fused"``,
``csrc/evidence.cu``). Every chain starts at a prior draw and burns in on
its own.

``proposal_scale="auto"`` (default) runs per-chain HG14 dual averaging
toward 0.234 during burn-in and freezes each chain's averaged scale for the
estimation phase; scalars and per-rung sequences are accepted too. Rungs
whose realized acceptance stays below ``min_acceptance`` warn.

Params may be a flat vector or any tree: the prior is a Distribution or a
tree of Distributions (dicts, tuples, lists; ``utils/tree.py``), and on the
torch engine ``loglik_fn`` receives params in that tree's structure; inside,
everything runs on the flat vector. The default ladder β_k = (k/(K−1))^5
concentrates rungs near β = 0, where E_β[log L] changes fastest.

The estimators run on the host in float64, from the f32 draws.
"""
from __future__ import annotations

import math
import types
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..distributions import Distribution, MvNormal, Normal
from ..models.density import DensityModel, as_model, logdensity_batched
from ..models.targets import TileDensityModel
from ..ops.evidence import fused_power_rwmh_sample, gaussian_prior_lp, power_step
from ..samplers.adapt import dual_average
from ..utils.keys import as_key, fold_in, generator, step_generator
from ..utils.tree import tree_flatten
from .fused import fused_seed


def power_ladder(n_rungs: int = 16, c: float = 5.0):
    """β_k = (k/(K−1))^c, k = 0..K−1 — rungs concentrated near the prior."""
    return tuple((k / (n_rungs - 1.0)) ** c for k in range(n_rungs))


def _is_dist(x) -> bool:
    return isinstance(x, Distribution)


def _prior_leaves(prior):
    leaves, unflatten = tree_flatten(prior, is_leaf=_is_dist)
    if not leaves or not all(_is_dist(leaf) for leaf in leaves):
        raise TypeError(
            "prior must be a Distribution or a tree of Distributions "
            "(each needs .sample and .log_prob)"
        )
    return leaves, unflatten


def _leaf_shapes(leaves, device) -> Tuple[Tuple[int, ...], ...]:
    """The shape of one draw of each leaf (from a throwaway draw)."""
    gen = generator(0, device)
    return tuple(tuple(leaf.sample(gen).shape) for leaf in leaves)


def _flatten_prior(prior, device):
    """A prior tree of Distributions → flat-vector machinery on ``device``.

    Returns ``(draw_flat(gen, n) -> (n, d), prior_lp_flat((n, d)) -> (n,),
    unravel((n, d)) -> tree with leading n, d)``. A single Distribution over
    vectors is the 1-leaf case: unravel of its flat block is the block itself,
    so ``loglik_fn`` keeps seeing plain vectors."""
    leaves, unflatten = _prior_leaves(prior)
    shapes = _leaf_shapes(leaves, device)
    sizes = [int(np.prod(s)) for s in shapes]
    d = sum(sizes)

    def draw_flat(gen, n: int) -> torch.Tensor:
        return torch.cat([leaf.sample(gen, (n,)).reshape(n, -1).to(torch.float32)
                          for leaf in leaves], dim=1)

    def unravel(flat: torch.Tensor):
        n, out, k = flat.shape[0], [], 0
        for shape, size in zip(shapes, sizes):
            out.append(flat[:, k:k + size].reshape((n,) + shape))
            k += size
        return unflatten(out)

    def prior_lp_flat(flat: torch.Tensor) -> torch.Tensor:
        n = flat.shape[0]
        vals = tree_flatten(unravel(flat))[0]
        total = None
        for leaf, x in zip(leaves, vals):
            lp = leaf.log_prob(x).reshape(n, -1).sum(dim=1)
            total = lp if total is None else total + lp
        return total

    return draw_flat, prior_lp_flat, unravel, d


def _gaussian_prior_columns(prior, device):
    """(loc, scale) flat float32 vectors of an elementwise-Gaussian prior
    tree, the fused engine's in-kernel prior. Raises for any leaf that is
    not a ``Normal`` or diagonal ``MvNormal``."""
    leaves, _ = _prior_leaves(prior)
    locs, scales = [], []
    for leaf, shape in zip(leaves, _leaf_shapes(leaves, device)):
        if isinstance(leaf, MvNormal):
            if leaf.scale_tril is not None:
                raise ValueError(
                    "engine='fused' log_evidence needs an elementwise "
                    "Gaussian prior (Normal / diagonal MvNormal); "
                    "scale_tril priors run on the torch engine."
                )
            s = leaf.scale_diag if leaf.scale_diag is not None else leaf.scale
        elif isinstance(leaf, Normal):
            s = leaf.scale
        else:
            raise ValueError(
                "engine='fused' log_evidence needs a Normal / diagonal "
                f"MvNormal prior tree (got {type(leaf).__name__}); "
                "general priors run on the torch engine."
            )
        col = lambda v: torch.broadcast_to(
            torch.as_tensor(v, dtype=torch.float32, device=device), shape).reshape(-1)
        locs.append(col(leaf.loc))
        scales.append(col(s))
    return torch.cat(locs).contiguous(), torch.cat(scales).contiguous()


def _evidence_estimates(
    lls, acc_np, scales, betas_t, n_samples, C, min_acceptance,
    stacklevel: int = 3,
) -> Dict[str, Any]:
    """Stepping-stone + TI estimates from rung draws ``lls (N, K, C)``,
    shared by both engines. Runs on the host in float64: the draws are f32,
    but the logsumexp chain accumulates K·N·C transcendentals, and f32 noise
    there would show against the exact-zero flat-likelihood contract."""
    if isinstance(lls, torch.Tensor):
        lls = lls.detach().cpu().numpy()
    lls = np.asarray(lls, np.float64)
    betas_arr = np.asarray(betas_t, np.float64)
    mean_ll = lls.mean(axis=(0, 2))  # (K,) E_β[log L]
    # TI: trapezoid over the ladder
    log_z_ti = float(np.sum(
        0.5 * (mean_ll[1:] + mean_ll[:-1]) * np.diff(betas_arr)
    ))

    def lse(a, axis):
        mx = np.max(a, axis=axis, keepdims=True)
        return mx.squeeze(axis) + np.log(np.sum(np.exp(a - mx), axis=axis))

    # Stepping-stone: Σ_k logmeanexp((β_{k+1}−β_k)·ℓ_k) over rung-k draws
    db = np.diff(betas_arr).reshape(-1, 1, 1)  # (K-1, 1, 1)
    rung_draws = lls[:, :-1, :].transpose(1, 0, 2)  # (K-1, N, C)
    # per-chain log-mean-exp (chains are independent → SE from their spread)
    m_kc = lse(db * rung_draws, axis=1) - math.log(n_samples)  # (K-1, C)
    m_k = lse(m_kc, axis=1) - math.log(C)  # (K-1,)
    log_z_ss = float(np.sum(m_k))
    # delta method: SE(log r̂_k) ≈ sd_c(w̃)/√C with w̃ = exp(m_kc − m_k)
    # (mean-1 normalized per-chain weights); rungs independent ⇒ quadrature.
    w = np.exp(m_kc - m_k[:, None])
    se_k = w.std(axis=1, ddof=1) / math.sqrt(C)
    se_ss = float(np.sqrt(np.sum(se_k**2)))

    bad = np.nonzero(acc_np < min_acceptance)[0]
    if bad.size:
        warnings.warn(
            f"log_evidence: ladder rungs {bad.tolist()} (β = "
            f"{[round(betas_t[i], 4) for i in bad.tolist()]}) have acceptance "
            f"{[round(float(acc_np[i]), 3) for i in bad.tolist()]} < "
            f"{min_acceptance}; their stepping-stone factors come from "
            "near-frozen chains and may bias log Z. Increase n_samples, use "
            "proposal_scale='auto', or refine the ladder.",
            UserWarning,
            stacklevel=stacklevel,
        )

    return {
        "log_z_ss": float(log_z_ss),
        "se_ss": se_ss,
        "log_z_ti": float(log_z_ti),
        "betas": betas_t,
        "mean_loglik": np.asarray(mean_ll),
        "acceptance": acc_np,
        "proposal_scales": scales,
    }


def _check_betas(betas):
    betas_t = tuple(float(b) for b in betas)
    if betas_t != tuple(sorted(betas_t)) or betas_t[0] != 0.0 or betas_t[-1] != 1.0:
        raise ValueError(
            "betas must ascend from 0.0 (prior) to 1.0 (posterior); "
            "use power_ladder() for the default schedule."
        )
    return betas_t


def _check_engine(engine: str) -> None:
    if engine == "xla":
        raise ValueError(
            "engine='xla' belongs to the JAX package; advancedmh_tpu_torch "
            "runs engine='torch' (the batched tensor loop) or engine='fused'"
        )
    if engine not in ("torch", "fused"):
        raise ValueError(f"Unknown engine: {engine!r}")


def _initial_scales(proposal_scale, K: int, per_rung: int, device) -> Tuple[torch.Tensor, bool]:
    """(ε₀ per chain (1, K·per_rung), adapt) from ``proposal_scale``."""
    if isinstance(proposal_scale, str):
        if proposal_scale != "auto":
            raise ValueError(f"unknown proposal_scale: {proposal_scale!r}")
        return torch.full((1, K * per_rung), 0.5, dtype=torch.float32, device=device), True
    ps = torch.as_tensor(proposal_scale, dtype=torch.float32, device=device)
    if ps.ndim == 0:
        return torch.full((1, K * per_rung), float(ps), dtype=torch.float32,
                          device=device), False
    if tuple(ps.shape) == (K,):
        return ps.repeat_interleave(per_rung)[None, :], False
    raise ValueError(
        f"proposal_scale must be 'auto', a scalar, or a length-{K} "
        f"per-rung sequence; got shape {tuple(ps.shape)}"
    )


def _device_of(loglik_fn, device):
    if device is not None:
        return torch.device(device)
    if isinstance(loglik_fn, DensityModel):
        return loglik_fn.device
    return torch.device("cuda")


def _step_noise(gen, d: int, B: int, device):
    """A torch-engine step's normals (d, B) and log u = −Exponential (1, B)."""
    z = torch.randn((d, B), generator=gen, device=device)
    logu = -torch.empty((1, B), device=device).exponential_(generator=gen)
    return z, logu


# HG14 dual-averaging constants of the torch engine (≙ samplers/adapt.py).
_T0_DA, _KAPPA, _GAMMA = 10.0, 0.75, 0.05


def _run_ladder(x, ll, plp, beta, eps0, adapt, loglik_t, prior_t, master, burn, n_samples,
                target_accept):
    """The torch engine's ladder batch: ``burn`` steps (dual averaging when
    ``adapt``, in the XLA engine's form: μ = log(10·ε₀), samplers/adapt.py::
    dual_average), then ``n_samples`` steps at the frozen scale; step j's
    noise from ``step_generator(master, j)``. Returns the log-likelihood
    draws and accept flags (N, 1, B) (None without draws) and the frozen ε
    (1, B)."""
    d, B = x.shape
    dev = x.device
    st = types.SimpleNamespace(log_eps_bar=torch.log(eps0), h_bar=torch.zeros_like(eps0))
    log_eps, mu = st.log_eps_bar, torch.log(10.0 * eps0)
    for j in range(1, burn + 1):
        z, logu = _step_noise(step_generator(master, j, dev), d, B, dev)
        eps = torch.exp(log_eps) if adapt else eps0
        x, ll, plp, acc = power_step(x, ll, plp, beta, eps, z, logu, loglik_t, prior_t)
        if adapt:
            st.t = torch.tensor(j, device=dev)
            log_eps, st.log_eps_bar, st.h_bar = dual_average(
                st, acc, target_accept, _T0_DA, _GAMMA, _KAPPA, mu)
    eps = torch.exp(st.log_eps_bar) if adapt else eps0
    lls, accs = [], []
    for j in range(burn + 1, burn + n_samples + 1):
        z, logu = _step_noise(step_generator(master, j, dev), d, B, dev)
        x, ll, plp, acc = power_step(x, ll, plp, beta, eps, z, logu, loglik_t, prior_t)
        lls.append(ll)
        accs.append(acc)
    if not lls:
        return None, None, eps
    return torch.stack(lls), torch.stack(accs).to(torch.float32), eps


def log_evidence(
    loglik_fn: Union[Callable[[Any], torch.Tensor], DensityModel],
    prior,
    n_samples: int,
    *,
    key: int,
    betas: Optional[Sequence[float]] = None,
    num_chains: int = 64,
    proposal_scale: Union[str, float, Sequence[float]] = "auto",
    discard_initial: Optional[int] = None,
    target_accept: float = 0.234,
    min_acceptance: float = 0.1,
    engine: str = "torch",
    loglik_tile_fn: Optional[Callable] = None,
    loglik_tile_consts: Tuple = (),
    tile_chains: int = 1024,
    d: Optional[int] = None,  # kept for API compat; inferred from the prior
    device=None,
) -> Dict[str, Any]:
    """Estimate log Z = log ∫ p(x) L(x) dx (≙ the JAX package's
    ``log_evidence``).

    ``loglik_fn`` — the log-likelihood: a function over a params tree (flat
    vector, or whatever structure the prior tree produces), or a
    ``DensityModel`` whose density is the log-likelihood; ``prior`` — a
    :class:`Distribution` or tree of Distributions (the proper prior p).
    Each ladder rung runs ``num_chains`` RWMH chains on p(x)·L(x)^{β_k};
    every chain starts at a prior draw and burns ``discard_initial`` steps
    (default ``n_samples``). Runs on ``device``: by default the model's, or
    the card for a plain function.

    ``proposal_scale``: ``"auto"`` (default — per-chain dual averaging to
    ``target_accept`` during burn-in, frozen after), a scalar, or a
    per-rung sequence of length ``len(betas)``.

    Returns a dict with ``log_z_ss`` (stepping-stone — use this), ``se_ss``
    (its Monte-Carlo standard error), ``log_z_ti`` (thermodynamic
    integration, trapezoid), the ladder ``betas``, per-rung
    ``mean_loglik``, ``acceptance``, and ``proposal_scales`` (per-rung
    median of the scales actually used). Any rung with acceptance below
    ``min_acceptance`` raises a ``UserWarning``.

    ``engine="torch"`` (default) runs the batch as a loop of tensor steps;
    step j draws its noise from ``utils.keys.step_generator(key, j)``.
    ``engine="fused"`` runs the whole K·C ladder batch in ONE launch of the
    CUDA kernel (``ops/evidence.py``, the plain PyTorch version on CPU
    tensors). It needs ``loglik_fn`` to be a ``TileDensityModel`` with a
    ``cuda_density`` (a device functor in ``csrc/common.cuh`` whose density
    is the log-likelihood over the flat vector, e.g.
    ``logistic_regression_model(..., prior_scale=math.inf)``) and a prior
    tree of elementwise Gaussians (``Normal`` / diagonal ``MvNormal``, the
    in-kernel prior density). ``loglik_tile_fn`` and ``loglik_tile_consts``
    replace the model's plain tile density and the constants the kernel
    reads (the functor is still the model's ``cuda_density``); the kernel
    cannot trace a function. ``tile_chains`` is accepted and ignored: the
    kernel masks its last block, so any chain count runs.
    """
    if betas is None:
        betas = power_ladder()
    betas_t = _check_betas(betas)
    _check_engine(engine)
    K = len(betas_t)
    C = num_chains
    B = K * C
    burn = n_samples if discard_initial is None else int(discard_initial)
    master = as_key(key)
    dev = _device_of(loglik_fn, device)
    draw_flat, prior_lp_flat, unravel, _ = _flatten_prior(prior, dev)
    beta_row = torch.tensor(betas_t, dtype=torch.float32, device=dev).repeat_interleave(C)[None]
    eps0, adapt = _initial_scales(proposal_scale, K, C, dev)
    x0 = draw_flat(step_generator(master, 0, dev), B)  # (B, d)

    if engine == "fused":
        return _log_evidence_fused(
            loglik_fn, prior, n_samples, betas_t=betas_t, C=C, burn=burn, master=master,
            x0=x0, beta_row=beta_row, eps0=eps0, adapt=adapt, target_accept=target_accept,
            min_acceptance=min_acceptance, loglik_tile_fn=loglik_tile_fn,
            loglik_tile_consts=loglik_tile_consts, device=dev,
        )

    model = as_model(loglik_fn, device=dev)

    def loglik_t(xt):  # (d, B) -> (1, B)
        return logdensity_batched(model, unravel(xt.T)).reshape(1, -1).to(torch.float32)

    def prior_t(xt):
        return prior_lp_flat(xt.T).reshape(1, -1)

    x_t = x0.T.contiguous()
    lls, accs, eps_final = _run_ladder(
        x_t, loglik_t(x_t), prior_t(x_t), beta_row, eps0, adapt, loglik_t, prior_t, master,
        burn, n_samples, target_accept)
    lls = lls.reshape(n_samples, K, C)
    acc = accs.reshape(n_samples, K, C).mean(dim=(0, 2)).cpu().numpy()
    scales = np.median(eps_final.reshape(K, C).cpu().numpy(), axis=1)
    return _evidence_estimates(lls, acc, scales, betas_t, n_samples, C, min_acceptance)


def _log_evidence_fused(
    loglik_fn, prior, n_samples, *, betas_t, C, burn, master, x0, beta_row, eps0, adapt,
    target_accept, min_acceptance, loglik_tile_fn, loglik_tile_consts, device,
) -> Dict[str, Any]:
    """Fused power-posterior run (see ``log_evidence``): one kernel launch
    for the whole K·C flat ladder batch, then the shared estimator code."""
    if not isinstance(loglik_fn, TileDensityModel) or loglik_fn.cuda_density is None:
        raise ValueError(
            "engine='fused' log_evidence needs loglik_fn to be a TileDensityModel with a "
            "cuda_density (a device functor of csrc/common.cuh whose density is the "
            "log-likelihood); other likelihoods run on engine='torch'"
        )
    model = loglik_fn
    if loglik_tile_fn is not None:
        tile_fn, consts = loglik_tile_fn, tuple(loglik_tile_consts)
    elif model.tile_density is not None:
        tile_fn, consts = model.tile_density, tuple(model.tile_consts)
    else:
        raise ValueError("engine='fused' log_evidence needs the model's tile_density "
                         "(or loglik_tile_fn)")
    K = len(betas_t)
    B = K * C
    loc, scale = _gaussian_prior_columns(prior, device)
    x_t = x0.T.contiguous()
    # ll₀ from the model's batched density over the flat start block (the
    # layout the functor sees), or from loglik_tile_fn where it replaces the
    # tile; plp₀ from the Gaussian columns.
    if loglik_tile_fn is None:
        ll0 = logdensity_batched(model, x0).reshape(1, B).to(torch.float32)
    else:
        ll0 = tile_fn(x_t, *consts).reshape(1, B).to(torch.float32)
    plp0 = gaussian_prior_lp(x_t, loc[:, None], scale[:, None], torch.log(scale)[:, None])
    lls, accs, eps_final = fused_power_rwmh_sample(
        tile_fn, model.cuda_density, x_t, ll0, plp0, beta_row, eps0, loc, scale, consts,
        fused_seed(master), n_samples=n_samples, burn=burn, adapt=adapt,
        target_accept=target_accept)
    lls = lls.reshape(n_samples, K, C)
    acc = accs.reshape(n_samples, K, C).mean(dim=(0, 2)).cpu().numpy()
    scales = np.median(eps_final.reshape(K, C).cpu().numpy(), axis=1)
    return _evidence_estimates(
        lls, acc, scales, betas_t, n_samples, C, min_acceptance,
        stacklevel=4,  # user -> log_evidence -> _log_evidence_fused -> here
    )


def log_evidence_ais(
    loglik_fn: Union[Callable[[Any], torch.Tensor], DensityModel],
    prior,
    *,
    key: int,
    betas: Optional[Sequence[float]] = None,
    num_chains: int = 1024,
    n_steps_per_rung: int = 4,
    proposal_scale: Union[str, float, Sequence[float]] = "auto",
    n_pilot: int = 200,
    target_accept: float = 0.234,
    min_acceptance: float = 0.05,
    device=None,
) -> Dict[str, Any]:
    """Annealed importance sampling (Neal 2001) estimate of log Z (≙ the
    JAX package's ``log_evidence_ais``).

    Every chain *sweeps* the ladder prior → posterior, accumulating the
    incremental importance weight ``w += (β_k − β_{k−1})·log L(x)`` (x ~
    π_{β_{k−1}}), then moves under ``n_steps_per_rung`` RWMH transitions
    targeting π_{β_k}. ``log Z = logmeanexp(w)`` is unbiased in Ẑ for any
    ladder and any number of inner steps; bad tuning widens the weight
    spread (``ess_weights``) but never biases it. Runs on the torch engine
    (as the JAX package's AIS runs on XLA only), on ``device``: by default
    the model's, or the card for a plain function. Rung k's step t draws its
    noise from the generator of absolute iteration k·T + t of the run's key.

    ``proposal_scale="auto"`` (default) runs a *pilot* flat ladder batch
    (``n_pilot`` steps of per-chain dual averaging, the :func:`log_evidence`
    scheme, min(64, num_chains) chains a rung) and freezes each rung's median
    scale BEFORE the measured sweep. Scalars and per-rung sequences are
    accepted too.

    Returns ``log_z_ais``, ``se_ais`` (delta-method SE from the weight
    spread), ``ess_weights`` (Kish effective sample size of the normalized
    weights), ``betas``, per-rung ``acceptance`` and ``proposal_scales``.
    A rung with acceptance below ``min_acceptance`` warns.
    """
    if betas is None:
        betas = power_ladder(32)
    betas_t = _check_betas(betas)
    if n_steps_per_rung < 1:
        raise ValueError("n_steps_per_rung must be >= 1")
    K = len(betas_t)
    C = num_chains
    T = int(n_steps_per_rung)
    master = as_key(key)
    key_pilot, key_run = fold_in(master, 1), fold_in(master, 2)
    dev = _device_of(loglik_fn, device)
    draw_flat, prior_lp_flat, unravel, dim = _flatten_prior(prior, dev)
    model = as_model(loglik_fn, device=dev)

    def loglik_t(xt):
        return logdensity_batched(model, unravel(xt.T)).reshape(1, -1).to(torch.float32)

    def prior_t(xt):
        return prior_lp_flat(xt.T).reshape(1, -1)

    betas_arr = torch.tensor(betas_t, dtype=torch.float32, device=dev)

    # -- per-rung proposal scales (frozen BEFORE the measured sweep) --------
    if isinstance(proposal_scale, str) and proposal_scale == "auto":
        Cp = min(64, C)
        Bp = K * Cp
        x0p = draw_flat(step_generator(key_pilot, 0, dev), Bp).T.contiguous()
        eps0 = torch.full((1, Bp), 0.5, dtype=torch.float32, device=dev)
        _, _, eps_p = _run_ladder(x0p, loglik_t(x0p), prior_t(x0p),
                                  betas_arr.repeat_interleave(Cp)[None], eps0, True, loglik_t,
                                  prior_t, key_pilot, n_pilot, 0, target_accept)
        eps_k = torch.quantile(eps_p.reshape(K, Cp), 0.5, dim=1)  # (K,)
    else:
        eps_k = _initial_scales(proposal_scale, K, 1, dev)[0][0]

    # -- the measured AIS sweep --------------------------------------------
    x = draw_flat(step_generator(master, 0, dev), C).T.contiguous()  # (d, C)
    ll, plp = loglik_t(x), prior_t(x)
    w = torch.zeros((1, C), dtype=torch.float32, device=dev)
    accs = []
    for k in range(1, K):
        beta = betas_arr[k]
        w = w + (betas_arr[k] - betas_arr[k - 1]) * ll
        n_acc = torch.zeros((1, C), dtype=torch.float32, device=dev)
        for t in range(T):
            z, logu = _step_noise(step_generator(key_run, k * T + t, dev), dim, C, dev)
            x, ll, plp, acc = power_step(x, ll, plp, beta, eps_k[k], z, logu, loglik_t, prior_t)
            n_acc = n_acc + acc.to(torch.float32)
        accs.append(n_acc.mean() / T)
    acc_np = torch.stack(accs).cpu().numpy()
    w64 = w[0].cpu().numpy().astype(np.float64)
    m = float(w64.max())
    log_z = m + math.log(float(np.mean(np.exp(w64 - m))))
    # delta method: Ẑ = mean(exp w) ⇒ SE(log Ẑ) ≈ sd(w̃)/√C with
    # w̃ = exp(w − log Ẑ) the mean-1 normalized weights.
    wt = np.exp(w64 - log_z)
    se = float(wt.std(ddof=1) / math.sqrt(C))
    ess_w = float(wt.sum() ** 2 / (wt**2).sum())  # Kish ESS

    bad = np.nonzero(acc_np < min_acceptance)[0]
    if bad.size:
        warnings.warn(
            f"log_evidence_ais: ladder rungs {(bad + 1).tolist()} (β = "
            f"{[round(betas_t[i + 1], 4) for i in bad.tolist()]}) have "
            f"acceptance {[round(float(a), 3) for a in acc_np[bad]]} < "
            f"{min_acceptance}; AIS stays unbiased but the weight spread "
            "grows — check ess_weights, and increase n_steps_per_rung or "
            "refine the ladder.",
            UserWarning,
            stacklevel=2,
        )

    return {
        "log_z_ais": log_z,
        "se_ais": se,
        "ess_weights": ess_w,
        "betas": betas_t,
        "acceptance": acc_np,
        "proposal_scales": eps_k.cpu().numpy(),
    }
