"""Adaptive-tempering Sequential Monte Carlo (SMC) sampler.

≙ advancedmh_tpu/runtime/smc.py: the particle member of the evidence stack
(TI / stepping-stone / AIS, runtime/evidence.py), whose output is both a
posterior sample and a marginal-likelihood estimate, with the temperature
schedule chosen by the data instead of a fixed ladder.

The Del Moral-Doucet-Jasra (2006) tempered-likelihood scheme,

    π_β(x) ∝ p(x) · L(x)^β,   β: 0 → 1 in adaptive steps,

per stage: (1) pick the next β' so the incremental weights
``w ∝ exp((β'−β)·ℓ)`` keep a target effective sample size (bisection on the
conditional ESS); (2) add the evidence increment ``log Z += log mean w``;
(3) systematic-resample the particles; (4) rejuvenate with
``mutation_steps`` RWMH steps targeting π_{β'}, the proposal scale set per
dimension from the current particle spread (2.38/√d · σ̂).

Particles are the chain batch, on the torch engine. The bisection runs on
the device (40 trips) and the stage's chosen β and its ESS fraction reach
the host in one read a stage (the number of stages is data-dependent: the
one loop that belongs on the host); the evidence increments and acceptance
rates stay on the device until the end.

Prior/params contract as ``log_evidence``: any tree of Distributions,
``loglik_fn`` over the same structure, flat-vector machinery inside.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from ..models.density import as_model, logdensity_batched
from ..ops.evidence import power_step
from ..utils.keys import as_key, fold_in, generator, step_generator
from .evidence import _device_of, _flatten_prior, _step_noise


def _systematic_resample(u0: torch.Tensor, logw: torch.Tensor, n: int) -> torch.Tensor:
    """Systematic resampling: indices ~ the categorical(w) coupling with one
    shared uniform offset ``u0`` — O(N), lowest-variance standard scheme.
    The points ``(u0 + i)/n`` are located in the cumulative weights by
    ``searchsorted`` (left side); the float32 cumsum can top out just below
    1, so the index is clamped to n − 1."""
    w = torch.softmax(logw, dim=0)
    cum = torch.cumsum(w, dim=0)
    pts = (u0 + torch.arange(n, dtype=torch.float32, device=logw.device)) / n
    return torch.clamp(torch.searchsorted(cum, pts), max=n - 1)


def _cess(dbeta, ll):
    """log ESS of the incremental weights exp(dβ·ℓ) (uniform W — stages
    resample every time, so weights enter each stage flat)."""
    a = dbeta * ll
    m = torch.max(a)
    s1 = torch.logsumexp(a - m, dim=0)
    s2 = torch.logsumexp(2.0 * (a - m), dim=0)
    return 2.0 * s1 - s2  # log(‖w‖₁²/‖w‖₂²); the max shift cancels


def _pick_beta(beta: torch.Tensor, ll: torch.Tensor, log_target: float):
    """Largest β' ≤ 1 with ESS(exp((β'−β)ℓ)) ≥ target: 40 bisection trips on
    the device (monotone in β'), in float32 as the JAX package's. Returns
    (β', its conditional-ESS fraction) as device scalars."""
    one = torch.ones((), dtype=torch.float32, device=ll.device)
    full = _cess(one - beta, ll) >= log_target
    lo, hi = beta, one
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        ok = _cess(mid - beta, ll) >= log_target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    b_next = torch.where(full, one, lo)
    return b_next, torch.exp(_cess(b_next - beta, ll)) / ll.shape[0]


def smc_sample(
    loglik_fn: Callable[[Any], torch.Tensor],
    prior,
    *,
    key: int,
    num_particles: int = 4096,
    target_ess_frac: float = 0.5,
    mutation_steps: int = 5,
    max_stages: int = 200,
    min_dbeta: float = 1e-5,
    device=None,
) -> Dict[str, Any]:
    """Run adaptive-tempering SMC from the prior to the posterior (≙ the JAX
    package's ``smc_sample``), on ``device``: by default the model's, or the
    card for a plain function.

    Returns a dict with ``particles`` (``(N, ...)`` posterior draws in the
    prior's tree structure — equally weighted after the final mutation),
    ``log_z`` (the SMC evidence estimate; no standard error, as in the JAX
    package), ``betas`` (the adaptive schedule actually taken, ending at
    1.0), ``ess_frac`` (the conditional ESS fraction of each stage's β),
    ``acceptance`` (mutation acceptance per stage), and ``n_stages``.

    ``target_ess_frac`` sets the schedule's resolution: each β-step is chosen
    so the incremental weights keep this fraction of effective particles.
    When that step would be smaller than ``min_dbeta``, the stage takes
    β + min_dbeta instead and ``ess_frac`` records the ESS fraction of the β
    taken (the JAX package records that of the smaller, unforced β).
    ``mutation_steps`` RWMH steps run after every resample at the
    2.38/√d·σ̂ scale of the current particle spread. Stage s's resampling
    offset and mutation noise come from the key folded with s + 1; the
    initial prior draws from the key's step 0.
    """
    if not 0.0 < target_ess_frac < 1.0:
        raise ValueError("target_ess_frac must be in (0, 1)")
    if mutation_steps < 1:
        raise ValueError("mutation_steps must be >= 1")
    N = int(num_particles)
    master = as_key(key)
    dev = _device_of(loglik_fn, device)
    draw_flat, prior_lp_flat, unravel, d = _flatten_prior(prior, dev)
    model = as_model(loglik_fn, device=dev)
    log_target = math.log(target_ess_frac * N)

    def loglik_t(xt):  # (d, N) -> (1, N)
        return logdensity_batched(model, unravel(xt.T)).reshape(1, -1).to(torch.float32)

    def prior_t(xt):
        return prior_lp_flat(xt.T).reshape(1, -1)

    x = draw_flat(step_generator(master, 0, dev), N).T.contiguous()  # (d, N)
    ll, plp = loglik_t(x), prior_t(x)
    if not bool((torch.isfinite(ll).all() & torch.isfinite(plp).all()).item()):
        raise ValueError(
            "smc_sample: non-finite log-likelihood or prior log-density "
            "at the initial prior draws - the ESS bisection cannot make "
            "progress. Guard the likelihood (e.g. clamp its support) "
            "before running SMC."
        )
    beta = 0.0
    betas, log_z_incs, accs, ess_hist = [0.0], [], [], []
    for s in range(max_stages):
        beta_t = torch.tensor(beta, dtype=torch.float32, device=dev)
        b_dev, cess_dev = _pick_beta(beta_t, ll[0], log_target)
        beta_next, ess_frac = (float(v) for v in torch.stack([b_dev, cess_dev]).cpu())
        if beta_next <= beta + min_dbeta and beta_next < 1.0:
            # Degenerate likelihood spread (e.g. huge N, tiny target ESS):
            # force minimal progress rather than stalling forever, and
            # record the ESS fraction of the β taken.
            beta_next = min(1.0, beta + min_dbeta)
            ess_frac = torch.exp(_cess(torch.tensor(beta_next, dtype=torch.float32, device=dev)
                                       - beta_t, ll[0])) / N
        b_next = torch.tensor(beta_next, dtype=torch.float32, device=dev)
        k_s = fold_in(master, s + 1)
        # evidence increment, resample at the new weights
        logw = (b_next - beta_t) * ll[0]
        log_z_incs.append(torch.logsumexp(logw, dim=0) - math.log(N))
        u0 = torch.rand((), generator=generator(fold_in(k_s, 0), dev), device=dev)
        idx = _systematic_resample(u0, logw, N)
        x, ll, plp = x[:, idx], ll[:, idx], plp[:, idx]
        # the no-knobs mutation scale from the current (resampled) spread
        scale = (2.38 / math.sqrt(d)) * torch.clamp(torch.std(x, dim=1, correction=0),
                                                    min=1e-10)[:, None]
        n_acc = torch.zeros((1, N), dtype=torch.float32, device=dev)
        for j in range(1, mutation_steps + 1):
            z, logu = _step_noise(step_generator(k_s, j, dev), d, N, dev)
            x, ll, plp, a = power_step(x, ll, plp, b_next, scale, z, logu, loglik_t, prior_t)
            n_acc = n_acc + a.to(torch.float32)
        accs.append(n_acc.mean() / mutation_steps)
        betas.append(beta_next)
        ess_hist.append(ess_frac)
        beta = beta_next
        if beta >= 1.0:
            break
    else:
        raise RuntimeError(
            f"SMC did not reach beta=1 in {max_stages} stages "
            f"(stalled at {beta:.4g}); raise max_stages or "
            "target_ess_frac."
        )

    log_z = float(torch.stack(log_z_incs).to(torch.float64).sum())
    return {
        "particles": unravel(x.T.contiguous()),
        "log_z": log_z,
        "betas": tuple(betas),
        "ess_frac": tuple(float(e) for e in ess_hist),
        "acceptance": tuple(float(a) for a in torch.stack(accs).cpu()),
        "n_stages": len(accs),
    }
