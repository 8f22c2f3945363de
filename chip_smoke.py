#!/usr/bin/env python3
"""Smoke run of advancedmh_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``advancedmh_tpu_torch/csrc/`` (nvcc, at first
use), checks each kernel against its plain PyTorch version on the card at
short cases, then drives each main path at full size through the public
entry points (``sample(engine="fused")`` + ``Chains.summary()``): RWMH (and
the ``fused_rwmh`` throughput kernel), Langevin MALA, Robust Adaptive
Metropolis (per chain and pooled), the emcee ensemble, slice 3: AdaptiveHMC
and HamiltonianMC on the d = 32 logistic regression at 8192 chains and
dual-averaging RWMH (``StepSizeAdaptation.rwmh``) on the flagship, slice 4:
ChEES-HMC and MEADS on the logistic regression at 8192 chains and MEADS on
Neal's funnel (d = 10), and slice 5: slice sampling on the funnel, elliptical
slice sampling on the d = 64 GP classification and regression, pCN on the
regression (8192 chains) and the Barker proposal on the flagship and the
logistic regression, and slice 6: Adaptive Metropolis and DRAM on correlated
Gaussians and delayed rejection on the flagship (16384 chains), with DRAM on
the Haario banana among the card-only checks, and slice 7: Multiple-Try
Metropolis (k = 4, and its ``fused_mtm`` throughput kernel) and replica
exchange (K = 5) on the flagship at 16384 chains and DE-MC on the emcee model
with one population of 16384 members, with the bimodal mixture among the
card-only checks, and slice 8: ``log_evidence`` on the d = 32 logistic
regression (the likelihood at ``prior_scale=inf``, its N(0, 10²I) prior
apart) at 16 rungs x 512 chains x (3000 + 3000) on both engines, with the
conjugate Normal-mean and flat likelihoods, AIS and SMC among the card-only
checks; MEADS runs a thread-block cluster per tile (held here also at 65,536
chains), AdaptiveHMC, HMC, ChEES's frozen phase and Barker 8 lanes a chain
on the logistic regression, and ESS 8 lanes a chain on the GP likelihoods:
their launch shapes, occupancy and registers it prints. Each path runs
with every launch counter set to 0 just before it and read just after. The
posteriors are checked against a float64 grid quadrature (the flagship),
the analytic means (emcee), the ``engine="torch"`` run and the
correlated-Gaussian checks of the JAX package's tests. Then it times each
kernel at its main path's shape against its plain version, and the whole
call with ESS/s, and the lag-window autocovariance of ``summary()``'s ESS
(``csrc/autocov.cu``, no TPU counterpart) beside its bound, its plain
version and the FFT path. The timed kernel outputs are held against the plain
versions' (emcee and DE-MC: their decisions over the whole run, their first
64 draws element-wise, and their means). Every phase that fails exits non-zero. The last
line of stdout is one JSON object: ``{"ok": true, "device": {...}}``; the
line before it lists the kernels with their launch counts, errors, times
and bounds.

There is no CPU path: without a CUDA device the script exits with code 1.
It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
N_CHAINS = 16384  # bench.py's ESS harness (16384 chains, 500 + 4000)
N_WARM = 500
N_DRAWS = 4000
N_STEPS_THROUGHPUT = 10_000  # bench.py's headline kernel run
SCALE = 0.35  # bench.py's hand-swept RWMH scale
MALA_S2 = 0.02  # bench.py's ess_per_s_mu_mala step size
N_CHECK = 2048  # chains of the correlated-Gaussian checks (tests/test_pallas.py)
KEY = 2024
LOGREG_CHAINS = 8192  # bench.py's logistic-regression harness: 8192 chains, 500 + 4000
N_LEAPFROG = 8  # bench.py's AdaptiveHMC: n_leapfrog=8, initial_step_size=0.05
AHMC_EPS0 = 0.05
LOGREG_RWMH_SCALE = 0.45  # bench.py's hand-tuned d = 32 yardsticks
LOGREG_MALA_S2 = 0.36
N_REF_CHAINS = 512  # the engine="torch" reference run on the logistic regression
N_REF_DRAWS = 600
N_PLAIN_HMC = 10  # steps of the plain HMC versions timed at 8192 chains
# The plain versions of the PR 1-2 kernels run once at their main path's
# shape (their flagship density sums the observations one by one, in the
# kernels' order, which made them 2-3x slower), as do slice 4's at their
# short shapes; kernels are best of 3.
PLAIN_REPEATS = 1

# Published peaks of one H100 SXM (NVIDIA's data sheet) for the bounds.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync() -> None:
    torch.cuda.synchronize()


def best_of(fn, repeats: int = 3):
    """Best wall time in seconds of ``fn()``, fenced by synchronize, and the
    result of the last call."""
    best, out = float("inf"), None
    for _ in range(repeats):
        out = None
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


def grid_posterior_means(data: np.ndarray):
    """Posterior means of (μ, σ) under a flat prior on σ > 0, by float64
    quadrature on a 4001 × 4000 grid."""
    x = data.astype(np.float64)
    n, s1, s2 = x.size, x.sum(), (x * x).sum()
    mu = np.linspace(-2.0, 2.0, 4001)[:, None]
    sig = np.linspace(0.0, 4.0, 4001)[1:][None, :]
    lp = -n * np.log(sig) - (s2 - 2.0 * mu * s1 + n * mu * mu) / (2.0 * sig * sig)
    w = np.exp(lp - lp.max())
    z = w.sum()
    return float((w * mu).sum() / z), float((w * sig).sum() / z)


# ---- launch counts -------------------------------------------------------------


def wrappers():
    from advancedmh_tpu_torch.ops import KERNEL_WRAPPERS

    return KERNEL_WRAPPERS


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def check_launches(path: str, got: dict, want: dict) -> None:
    """The main path ``path`` launched exactly the kernels ``want`` (name ->
    count) and no other."""
    expect = {name: want.get(name, 0) for name in got}
    print(f"{path} launches: {got}")
    check(got == expect, f"{path} launches {got}, expected {expect}")


# ---- kernel against plain version ------------------------------------------------


def _start(C: int, seed: int):
    """Per-chain starts: μ ~ N(0, 1), σ ~ U(-0.5, 2), so some chains start
    outside the support (lp = -inf)."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.normal(size=C), rng.uniform(-0.5, 2.0, size=C)])
    return torch.tensor(p, dtype=torch.float32, device=DEVICE)


def _gauss_start(d: int, C: int, seed: int):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(d, C)), dtype=torch.float32, device=DEVICE)


def _close(a, b):
    """States and lp: |a - b| <= 1e-5 + 1e-5·|b| (inf equal to inf)."""
    return torch.isclose(a, b, rtol=1e-5, atol=1e-5)


def _max_err(got, ref, ok):
    """Largest |got - ref| over the finite entries of the chains in ``ok``."""
    sel = ok.expand_as(got) & torch.isfinite(ref)
    return float((got - ref).abs()[sel].max()) if bool(sel.any()) else 0.0


def agreement(got, ref):
    """A kernel's outputs against its plain version's, chains on the last axis.

    ``got`` and ``ref`` are (states, lp, accepted, *final) of a sampling
    kernel, with accepted (N, 1, C) holding each emitted step's decision and
    ``final`` the per-chain tensors it returns besides (MALA's gradient,
    RAM's factor S), or (states, lp, counts) of the throughput kernel, with
    counts (1, C). A chain is ok when all its decisions (or its count) agree
    and its states, lp and finals are within ``_close``; ``max_abs_err`` is
    over the states and lp of the ok chains."""
    (s, l, a, *fin), (s_r, l_r, a_r, *fin_r) = got, ref
    check(s.shape == s_r.shape and l.shape == l_r.shape and a.shape == a_r.shape,
          "kernel and plain output shapes differ")
    dec_equal = (a == a_r).reshape(-1, a.shape[-1])  # (decisions, C)
    same_decisions = dec_equal.all(dim=0)
    lead = tuple(range(s.ndim - 1))
    close = _close(s, s_r).all(dim=lead) & _close(l, l_r).all(dim=lead)
    for f, f_r in zip(fin, fin_r):
        close = close & _close(f, f_r).all(dim=0)
    ok = same_decisions & close
    return dict(
        per_step=a.ndim == 3,
        decisions=float(dec_equal.float().mean()),
        chains_ok=float(ok.float().mean()),
        hidden=int((same_decisions & ~close).sum()),
        max_abs_err=max(_max_err(s, s_r, ok), _max_err(l, l_r, ok)),
        max_abs_err_states=_max_err(s, s_r, ok),
        max_abs_err_lp=_max_err(l, l_r, ok),
        identical=bool(torch.equal(s, s_r) and torch.equal(l, l_r) and torch.equal(a, a_r)),
    )


# Over thousands of steps a chain whose accept test lands within the last bit
# of its threshold (lp differs from the plain version's in the last bits: the
# observation sum runs in another order) takes the other branch and follows
# another path from there on. That happened 2.6e-7 times per chain-step on
# the H100 (0.27% of chains after 10000 steps). So a long run is held to 99%
# of chains; an emission or indexing fault would break nearly every chain.
SHORT_RUN_CHAINS_MIN = 0.999
LONG_RUN_CHAINS_MIN = 0.99


def check_agreement(name, r, chains_min, visible_steps):
    """The stated tolerance: >= 99.9% of (chain, step) decisions agree (a
    sampling kernel) and at least ``chains_min`` of the chains agree in every
    output; with every step visible, no chain whose decisions all agree may
    differ in state or lp beyond ``_close``."""
    if r["per_step"]:
        check(r["decisions"] >= 0.999, f"{name} decisions agree {r['decisions']:.5f} < 0.999")
    check(r["chains_ok"] >= chains_min,
          f"{name} chains agree {r['chains_ok']:.5f} < {chains_min}")
    if visible_steps:
        check(r["hidden"] == 0, f"{name}: chains with equal decisions disagree")


def compare_sample_kernel(model, C, scale, burn, thin, n, offset, seed):
    """Kernel A against rwmh_sample_reference on the same inputs."""
    from advancedmh_tpu_torch.ops import fused_rwmh_sample, rwmh_sample_reference

    p = _start(C, seed)
    lp = model.tile_density(p, *model.tile_consts)
    args = (model.tile_density, model.cuda_density, p, lp, scale,
            model.tile_consts, 0x5EED0000 + seed)
    kw = dict(burn=burn, thin=thin, n_samples=n, iteration_offset=offset)
    got = fused_rwmh_sample(*args, **kw)
    check(got[0].shape == (n, 2, C) and got[1].shape == (n, 1, C), "kernel A output shapes")
    return agreement(got, rwmh_sample_reference(*args, **kw))


def compare_step_kernel(model, C, scale, n_steps, offset, seed):
    """Kernel B against rwmh_reference on the same inputs."""
    from advancedmh_tpu_torch.ops import fused_rwmh, rwmh_reference

    p = _start(C, seed)
    lp = model.tile_density(p, *model.tile_consts)
    args = (model.tile_density, model.cuda_density, p, lp, scale,
            model.tile_consts, 0x5EED0000 + seed)
    got = fused_rwmh(*args, n_steps=n_steps, iteration_offset=offset)
    check(got[0].shape == (2, C) and got[2].shape == (1, C), "kernel B output shapes")
    return agreement(got, rwmh_reference(*args, n_steps=n_steps, iteration_offset=offset))


def phase_kernels_rwmh(model, errs):
    diag = torch.tensor([SCALE, SCALE], device=DEVICE)
    tril = torch.tensor([[0.35, 0.0], [0.1, 0.3]], device=DEVICE)
    cases_a = [  # (C, scale, burn, thin, n_samples, iteration_offset)
        (4096, diag, 0, 1, 64, 0),
        (4000, tril, 0, 1, 64, 0),
        (4000, diag, 10, 3, 17, 1000),
        (4096, tril, 7, 1, 57, (1 << 32) - 30),  # crosses the counter's 32-bit word
    ]
    for i, (C, scale, burn, thin, n, off) in enumerate(cases_a):
        r = compare_sample_kernel(model, C, scale, burn, thin, n, off, seed=i)
        print(f"kernel rwmh_sample C={C} {'tril' if scale.ndim == 2 else 'diag'} "
              f"burn={burn} thin={thin} n={n} offset={off}: {r}")
        check_agreement("rwmh_sample", r, SHORT_RUN_CHAINS_MIN,
                        visible_steps=burn == 0 and thin == 1)
        errs["rwmh_sample"] = max(errs["rwmh_sample"], r["max_abs_err"])
    for i, (C, scale, n_steps, off) in enumerate([(4000, diag, 63, 0), (4096, tril, 63, 77)]):
        r = compare_step_kernel(model, C, scale, n_steps, off, seed=10 + i)
        print(f"kernel rwmh C={C} {'tril' if scale.ndim == 2 else 'diag'} "
              f"n_steps={n_steps} offset={off}: {r}")
        check_agreement("rwmh", r, SHORT_RUN_CHAINS_MIN, visible_steps=False)
        errs["rwmh"] = max(errs["rwmh"], r["max_abs_err"])


def mala_args(model, p, seed):
    lp, g = model.tile_value_and_grad(p, *model.tile_consts)
    return (model.tile_value_and_grad, model.cuda_density, p, lp, g, model.tile_consts, seed)


def ram_args(model, p, seed, s0=1.0):
    d, C = p.shape
    S = (s0 * torch.eye(d, device=DEVICE)).reshape(d * d, 1).expand(d * d, C).contiguous()
    lp = model.tile_density(p, *model.tile_consts)
    return (model.tile_density, model.cuda_density, p, lp, S, model.tile_consts, seed)


def emcee_start(W: int, seed: int):
    """Walkers s ~ U(-0.2, 4) (some outside the support), m ~ N(1, 1)."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-0.2, 4.0, W), rng.normal(1.0, 1.0, W)])
    return torch.tensor(x, dtype=torch.float32, device=DEVICE)


def phase_kernels_new(models, errs):
    """MALA, RAM and emcee against their plain versions at short cases:
    ragged C or W, burn/thin > 1, an offset crossing the counter's 32-bit
    word, starts outside the support, RAM with and without eigenvalue
    bounds, emcee with tile_walkers < W, the correlated Gaussian at d = 2
    and 4."""
    from advancedmh_tpu_torch.ops import (RamParams, emcee_sample_reference,
                                          fused_emcee_sample, fused_mala_sample,
                                          fused_ram_sample, mala_sample_reference,
                                          ram_sample_reference)

    flag, corr2, corr4, demo = (models[k] for k in ("flagship", "corr", "corr4", "emcee"))
    mala_cases = [  # (model, s2, C, burn, thin, n, offset, start)
        (flag, MALA_S2, 4096, 0, 1, 64, 0, "support"),
        (flag, MALA_S2, 4000, 10, 3, 17, 1000, "support"),
        (corr2, 0.5, 4000, 0, 1, 64, (1 << 32) - 30, "gauss"),
        (corr4, 0.3, 3001, 7, 2, 20, 5, "gauss"),
    ]
    for i, (m, s2, C, burn, thin, n, off, start) in enumerate(mala_cases):
        p = _start(C, 20 + i) if start == "support" else _gauss_start(m.dimension, C, 20 + i)
        args = mala_args(m, p, 0xA1A0 + i)
        kw = dict(step_size_sq=s2, burn=burn, thin=thin, n_samples=n, iteration_offset=off)
        got = fused_mala_sample(*args, **kw)
        ref = mala_sample_reference(*args, **kw)
        r = agreement(got[:3], ref[:3])
        g_ok = hold_gradient("mala", got[3], ref[3], got[0], ref[0], got[2], ref[2])
        print(f"kernel mala {m.cuda_density} d={m.dimension} C={C} burn={burn} thin={thin} "
              f"n={n} offset={off}: {r} final-gradient agree {g_ok:.5f}")
        check_agreement("mala", r, SHORT_RUN_CHAINS_MIN, visible_steps=burn == 0 and thin == 1)
        errs["mala"] = max(errs["mala"], r["max_abs_err"])

    ram_cases = [  # (model, C, warmup, thin, n, offset, bounds, S0)
        (flag, 4096, 64, 1, 32, 0, (0.0, float("inf")), 1.0),
        (flag, 4000, 40, 3, 11, (1 << 32) - 60, (0.05, 0.5), 0.3),
        (corr2, 4000, 64, 1, 32, 7, (0.0, float("inf")), 1.0),
        (corr4, 3001, 30, 2, 10, 0, (0.3, 1.5), 0.8),
    ]
    for i, (m, C, warmup, thin, n, off, bounds, s0) in enumerate(ram_cases):
        p = _start(C, 30 + i) if m is flag else _gauss_start(m.dimension, C, 30 + i)
        args = ram_args(m, p, 0xBA50 + i, s0)
        kw = dict(warmup=warmup, thin=thin, n_samples=n, iteration_offset=off,
                  params=RamParams(eig_lo=bounds[0], eig_hi=bounds[1]))
        r = agreement(fused_ram_sample(*args, **kw), ram_sample_reference(*args, **kw))
        print(f"kernel ram {m.cuda_density} d={m.dimension} C={C} warmup={warmup} "
              f"thin={thin} n={n} offset={off} bounds={bounds}: {r}")
        check_agreement("ram", r, SHORT_RUN_CHAINS_MIN, visible_steps=False)
        errs["ram"] = max(errs["ram"], r["max_abs_err"])

    emcee_cases = [  # (W, tile_walkers, burn, thin, n, offset)
        (N_CHAINS, N_CHAINS, 0, 1, 64, 0),  # the main path's one ensemble
        (4096, 4096, 0, 1, 64, 0),
        (4000, 1000, 5, 2, 20, 11),
        (3000, 600, 0, 1, 48, (1 << 32) - 20),
    ]
    for i, (W, T, burn, thin, n, off) in enumerate(emcee_cases):
        x = emcee_start(W, 40 + i)
        args = (demo.tile_density, demo.cuda_density, x, demo.tile_density(x),
                demo.tile_consts, 0xE3C0 + i)
        kw = dict(stretch_length=2.0, tile_walkers=T, burn=burn, thin=thin, n_samples=n,
                  iteration_offset=off)
        r = agreement(fused_emcee_sample(*args, **kw), emcee_sample_reference(*args, **kw))
        print(f"kernel emcee W={W} tile_walkers={T} burn={burn} thin={thin} n={n} "
              f"offset={off}: {r}")
        check_agreement("emcee", r, SHORT_RUN_CHAINS_MIN, visible_steps=burn == 0 and thin == 1)
        errs["emcee"] = max(errs["emcee"], r["max_abs_err"])
    sync()


# ---- the main paths -------------------------------------------------------------


def posterior_check(path, summary, mu_q, sig_q, names=("μ", "σ")):
    check(abs(summary[names[0]]["mean"] - mu_q) < 0.01, f"{path}: μ mean vs quadrature")
    check(abs(summary[names[1]]["mean"] - sig_q) < 0.01, f"{path}: σ mean vs quadrature")
    check(all(summary[n]["rhat"] < 1.01 for n in names), f"{path}: R-hat >= 1.01")


def phase_main_rwmh(model, label, launches):
    from advancedmh_tpu_torch import MvNormal, RWMH, ess_bulk, sample
    from advancedmh_tpu_torch.ops import fused_rwmh, fused_rwmh_sample

    spl = RWMH(MvNormal(torch.zeros(2, device=DEVICE), scale=SCALE))
    p0 = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, N_CHAINS).contiguous()
    lp0 = model.tile_density(p0, *model.tile_consts)

    reset_launches()
    fused_rwmh_sample.group_launches = fused_rwmh.group_launches = 0
    sync()
    t0 = time.perf_counter()
    result = sample(model, spl, N_DRAWS, num_chains=N_CHAINS, engine="fused",
                    discard_initial=N_WARM, initial_params=[0.0, 1.0], key=KEY)
    chains = result.to_chains(param_names=["μ", "σ"])
    summary = chains.summary()
    sync()
    t_path = time.perf_counter() - t0
    _, _, acc_b = fused_rwmh(model.tile_density, model.cuda_density, p0, lp0, SCALE,
                             model.tile_consts, KEY, n_steps=N_STEPS_THROUGHPUT)
    sync()
    got = read_launches()
    check_launches("rwmh main path", got, {"rwmh_sample": 1, "rwmh": 1})
    groups = (fused_rwmh_sample.group_launches, fused_rwmh.group_launches)
    print(f"rwmh main path group launches: {groups}")
    check(groups == (1, 1), "rwmh main path: a kernel left the flagship's group form")
    launches.update(rwmh_sample=got["rwmh_sample"], rwmh=got["rwmh"])

    check(chains.values.shape == (N_DRAWS, 2, N_CHAINS), "Chains shape")
    check(bool(torch.isfinite(chains.values).all()), "non-finite draws")
    mu_q, sig_q = grid_posterior_means(model.tile_consts[0].cpu().numpy().ravel())
    acc = float(result.transitions.accepted.float().mean())
    acc_b_rate = float(acc_b.mean()) / N_STEPS_THROUGHPUT
    print(f"rwmh summary: {json.dumps(summary)}")
    print(f"grid quadrature means: mu={mu_q:.6f} sigma={sig_q:.6f}; "
          f"acceptance {acc:.4f} (fused_rwmh {acc_b_rate:.4f})")
    posterior_check("rwmh", summary, mu_q, sig_q)
    check(0.05 < acc < 0.95 and 0.05 < acc_b_rate < 0.95, "degenerate acceptance")

    # engine="torch" on the card: the tolerances of tests/test_pallas.py
    n_t, c_t = 2000, 2048

    def run_torch():
        return sample(model, spl, n_t, num_chains=c_t, engine="torch",
                      discard_initial=N_WARM, initial_params=[0.0, 1.0], key=KEY + 1,
                      chain_type="chains", param_names=["μ", "σ"])

    ref = run_torch()
    ref_mu, ref_sig = float(ref.mean("μ")), float(ref.mean("σ"))
    print(f"engine=torch {c_t}x{n_t}: mu={ref_mu:.5f} sigma={ref_sig:.5f}")
    check(abs(ref_mu - summary["μ"]["mean"]) < 0.05, "torch vs fused μ")
    check(abs(ref_sig - summary["σ"]["mean"]) < 0.05, "torch vs fused σ")
    t_torch, _ = best_of(run_torch)
    torch_rate = c_t * (N_WARM + n_t - 1) / t_torch
    print(f"[{label}] engine=torch: {torch_rate:.6e} chain-steps/s "
          f"({c_t} chains x {N_WARM + n_t - 1} steps, {t_torch:.4f} s, best of 3, "
          f"incl. its Python loop)")

    ess_mu = float(ess_bulk(chains["μ"]))
    print(f"[{label}] first sample(engine='fused')+summary: {t_path:.4f} s, "
          f"ess_bulk(mu)={ess_mu:.1f}")
    return spl, p0, lp0


def phase_main_mala(model, label, launches):
    """MALA.langevin(0.02) on the flagship at 16384 × (500 + 4000)."""
    from advancedmh_tpu_torch import MALA, sample

    spl = MALA.langevin(MALA_S2)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    result = sample(model, spl, N_DRAWS, num_chains=N_CHAINS, engine="fused",
                    discard_initial=N_WARM, initial_params=[0.0, 1.0], key=KEY + 10)
    chains = result.to_chains(param_names=["μ", "σ"])
    summary = chains.summary()
    sync()
    t_path = time.perf_counter() - t0
    got = read_launches()
    check_launches("mala main path", got, {"mala": 1})
    launches["mala"] = got["mala"]
    check(chains.values.shape == (N_DRAWS, 2, N_CHAINS), "mala Chains shape")
    check(bool(torch.isfinite(chains.values).all()), "mala: non-finite draws")
    mu_q, sig_q = grid_posterior_means(model.tile_consts[0].cpu().numpy().ravel())
    acc = float(result.transitions.accepted.float().mean())
    print(f"mala summary: {json.dumps(summary)}; acceptance {acc:.4f}; "
          f"first sample+summary {t_path:.4f} s")
    posterior_check("mala", summary, mu_q, sig_q)
    check(0.1 < acc < 0.98, f"mala acceptance {acc}")

    ref = sample(model, spl, 2000, num_chains=N_CHECK, engine="torch", discard_initial=N_WARM,
                 initial_params=[0.0, 1.0], key=KEY + 11, chain_type="chains",
                 param_names=["μ", "σ"])
    ref_mu, ref_sig = float(ref.mean("μ")), float(ref.mean("σ"))
    print(f"mala engine=torch {N_CHECK}x2000: mu={ref_mu:.5f} sigma={ref_sig:.5f}")
    check(abs(ref_mu - summary["μ"]["mean"]) < 0.05, "mala torch vs fused μ")
    check(abs(ref_sig - summary["σ"]["mean"]) < 0.05, "mala torch vs fused σ")
    return spl


def phase_main_ram(model, label, launches):
    """RobustAdaptiveMetropolis() per chain and pooled on the flagship at
    16384 × (500 warmup + 4000)."""
    from advancedmh_tpu_torch import RobustAdaptiveMetropolis, sample

    mu_q, sig_q = grid_posterior_means(model.tile_consts[0].cpu().numpy().ravel())
    for pooled in (False, True):
        path = "ram pooled" if pooled else "ram"
        reset_launches()
        sync()
        t0 = time.perf_counter()
        result = sample(model, RobustAdaptiveMetropolis(pooled=pooled), N_DRAWS,
                        num_chains=N_CHAINS, engine="fused", num_warmup=N_WARM,
                        discard_initial=N_WARM, initial_params=[0.0, 1.0], key=KEY + 20)
        chains = result.to_chains(param_names=["μ", "σ"])
        summary = chains.summary()
        sync()
        t_path = time.perf_counter() - t0
        got = read_launches()
        check_launches(f"{path} main path", got, {"ram": 1})
        launches["ram"] = launches.get("ram", 0) + got["ram"]
        acc = float(result.transitions.accepted.float().mean())
        S = result.final_state.S
        print(f"{path} summary: {json.dumps(summary)}; acceptance {acc:.4f}; "
              f"mean final S {S.mean(0).tolist()}; first sample+summary {t_path:.4f} s")
        check(chains.values.shape == (N_DRAWS, 2, N_CHAINS), f"{path} Chains shape")
        check(bool(torch.isfinite(chains.values).all()), f"{path}: non-finite draws")
        posterior_check(path, summary, mu_q, sig_q)
        check(0.05 < acc < 0.95, f"{path} acceptance {acc}")
        if pooled:
            check(bool((S == S[:1]).all()), "pooled RAM: S is not shared by all chains")


def emcee_sampler():
    """The main path's ensemble: N_CHAINS walkers, prior draws to start."""
    from advancedmh_tpu_torch import Ensemble, InverseGamma, Normal, StretchProposal

    return Ensemble(N_CHAINS, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]))


def phase_main_emcee(model, label, launches):
    """Ensemble(16384, StretchProposal([InverseGamma(2, 3), Normal(0, 1)])) on
    the emcee model: 4000 draws after 500 discarded, one ensemble."""
    from advancedmh_tpu_torch import sample

    reset_launches()
    sync()
    t0 = time.perf_counter()
    result = sample(model, emcee_sampler(), N_DRAWS, engine="fused",
                    discard_initial=N_WARM, key=KEY + 30)
    chains = result.to_chains(param_names=["s", "m"])
    summary = chains.summary()
    sync()
    t_path = time.perf_counter() - t0
    got = read_launches()
    check_launches("emcee main path", got, {"emcee": 1})
    launches["emcee"] = got["emcee"]
    params = result.transitions.params
    acc = float(result.transitions.accepted.float().mean())
    s_mean, m_mean = summary["s"]["mean"], summary["m"]["mean"]
    print(f"emcee summary: {json.dumps(summary)}; acceptance {acc:.4f}; "
          f"first sample+summary {t_path:.4f} s")
    print(f"emcee means: s={s_mean:.5f} (49/24 = {49 / 24:.5f}), "
          f"m={m_mean:.5f} (7/6 = {7 / 6:.5f})")
    check(tuple(params.shape) == (N_DRAWS, N_CHAINS, 2), f"emcee shape {tuple(params.shape)}")
    check(bool(torch.isfinite(params).all()), "emcee: non-finite draws")
    check(abs(s_mean - 49 / 24) < 0.1 and abs(m_mean - 7 / 6) < 0.1, "emcee means")
    check(0.1 < acc < 0.9, f"emcee acceptance {acc}")


def phase_correlated(models):
    """tests/test_pallas.py's correlated-Gaussian checks at 2048 chains."""
    from advancedmh_tpu_torch import MALA, RobustAdaptiveMetropolis, sample

    sig = np.array([[1.5, 0.35], [0.35, 1.0]])
    res = sample(models["corr"], MALA.langevin(0.5), 4000, key=6, num_chains=N_CHECK,
                 engine="fused", discard_initial=1000, initial_params=[1.0, 1.0])
    draws = res.transitions.params.reshape(-1, 2).double().cpu().numpy()
    mean, cov = draws.mean(0), np.cov(draws.T)
    x = res.final_state.params.double().cpu().numpy()
    grad_err = np.abs(res.final_state.gradient.double().cpu().numpy()
                      + (np.linalg.inv(sig) @ x.T).T).max()
    print(f"correlated mala {N_CHECK}x4000: mean {mean.tolist()} cov {cov.tolist()} "
          f"final-gradient |err| {grad_err:.3g}")
    check(np.all(np.abs(mean) < 0.05), "correlated mala mean")
    check(np.allclose(cov, sig, rtol=0, atol=0.1), "correlated mala covariance")
    check(grad_err < 1e-3 * (1 + np.abs(x).max()), "correlated mala final gradient")

    sig = np.array([[1.0, 0.5], [0.5, 1.0]])
    res = sample(models["corr_ram"], RobustAdaptiveMetropolis(), 4000, key=5,
                 num_chains=N_CHECK, engine="fused", num_warmup=4000,
                 initial_params=[0.0, 0.0])
    draws = res.transitions.params.reshape(-1, 2).double().cpu().numpy()
    cov = np.cov(draws.T)
    acc = float(res.transitions.accepted.float().mean())
    S = res.final_state.S.double().cpu().numpy()
    SS = np.einsum("cij,ckj->cik", S, S).mean(0)
    corr = SS[0, 1] / np.sqrt(SS[0, 0] * SS[1, 1])
    print(f"correlated ram {N_CHECK}x(4000+4000): cov {cov.tolist()} acceptance {acc:.4f} "
          f"corr(SS') {corr:.4f}")
    check(np.allclose(cov, sig, rtol=0.1, atol=0.05), "correlated ram covariance")
    check(abs(acc - 0.234) < 0.05, "correlated ram acceptance")
    check(abs(corr - 0.5) < 0.1, "correlated ram corr(SS')")


# ---- slice 3: dual-averaging RWMH, HMC, AdaptiveHMC ------------------------------------


def _logreg_start(C: int, seed: int):
    rng = np.random.default_rng(seed)
    return torch.tensor(0.3 * rng.normal(size=(32, C)), dtype=torch.float32, device=DEVICE)


def _slice3_start(m, C, seed):
    if m.cuda_density == "gaussian_mean_scale":
        return _start(C, seed)
    if m.cuda_density == "logistic_regression":
        return _logreg_start(C, seed)
    return _gauss_start(m.dimension, C, seed)


def hmc_args(m, p, seed):
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    return (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, seed)


def hold_gradient(name, got_g, ref_g, got_s, ref_s, got_a, ref_a):
    """The final gradient, on the chains whose draws and decisions agree, at
    1e-4: the flagship's σ component is n·m − Σ z·r over m·m, two terms that
    nearly cancel, so a last-bit difference in either moves it far more
    than the states."""
    same = (got_a == ref_a).all(0)[0] & _close(got_s, ref_s).all(dim=(0, 1))
    g_ok = float(torch.isclose(got_g, ref_g, rtol=1e-4, atol=1e-4).all(0)[same].float().mean())
    check(g_ok == 1.0, f"{name}: the final gradient differs from the plain version's")
    return g_ok


def phase_kernels_slice3(models, errs):
    """dual-averaging RWMH, HMC and AdaptiveHMC against their plain versions
    at 64-step cases (the flagship with starts outside the support, the
    correlated Gaussian, the logistic regression at 8192 × 32; ragged C,
    burn/thin, an offset across the counter's 32-bit word, the resume
    variants, a diagonal M⁻¹ ≠ 1), and the logistic regression's RWMH and
    MALA yardsticks at 8192 chains."""
    from advancedmh_tpu_torch.ops import (DualAveraging, adapt_rwmh_reference,
                                          adaptive_hmc_reference, fused_adapt_rwmh_sample,
                                          fused_adaptive_hmc_sample, fused_hmc_sample,
                                          fused_mala_sample, fused_rwmh_sample,
                                          hmc_sample_reference, mala_sample_reference,
                                          minv_column, rwmh_sample_reference)

    flag, corr, lr = models["flagship"], models["corr"], models["logreg"]
    hmc_cases = [  # (model, eps, M⁻¹, C, burn, thin, n, offset)
        (flag, 0.03, (1.0, 1.0), 4096, 0, 1, 64, 0),
        (corr, 0.4, (1.5, 0.7), 4000, 10, 3, 17, 1000),
        (corr, 0.3, (1.0, 1.0), 3001, 0, 1, 40, (1 << 32) - 30),
        (lr, 0.05, "linspace", LOGREG_CHAINS, 0, 1, 64, 0),
    ]
    for i, (m, eps, mv, C, burn, thin, n, off) in enumerate(hmc_cases):
        d = m.dimension
        minv = minv_column(torch.linspace(0.5, 1.5, d) if mv == "linspace" else torch.tensor(mv),
                           d, DEVICE)
        args = hmc_args(m, _slice3_start(m, C, 60 + i), 0x4AC0 + i)
        kw = dict(step_size=eps, n_leapfrog=N_LEAPFROG, inverse_mass=minv, burn=burn,
                  thin=thin, n_samples=n, iteration_offset=off)
        got, ref = fused_hmc_sample(*args, **kw), hmc_sample_reference(*args, **kw)
        r = agreement(got[:3], ref[:3])
        g_ok = hold_gradient("hmc", got[3], ref[3], got[0], ref[0], got[2], ref[2])
        print(f"kernel hmc {m.cuda_density} d={d} eps={eps} minv={mv} C={C} burn={burn} "
              f"thin={thin} n={n} offset={off}: {r} final-gradient agree {g_ok:.5f}")
        check_agreement("hmc", r, SHORT_RUN_CHAINS_MIN, visible_steps=burn == 0 and thin == 1)
        errs["hmc"] = max(errs["hmc"], r["max_abs_err"])

    rng = np.random.default_rng(70)

    def frozen(C, d, scale):
        leb = torch.tensor(np.log(scale * rng.uniform(0.5, 1.5, (1, C))), dtype=torch.float32,
                           device=DEVICE)
        minv = torch.tensor(rng.uniform(0.5, 2.0, (d, C)), dtype=torch.float32, device=DEVICE)
        return leb, minv

    ahmc_cases = [  # (model, C, warmup, thin, n, offset, resume scale)
        (flag, 4000, 40, 1, 24, 0, None),
        (corr, 4096, 40, 1, 24, 7, None),
        (corr, 3001, 20, 3, 11, (1 << 32) - 60, None),
        (lr, LOGREG_CHAINS, 32, 1, 32, 0, None),
        (corr, 4000, 0, 2, 20, 5, 0.3),
        (flag, 4000, 0, 1, 32, 11, 0.01),
        (lr, LOGREG_CHAINS, 0, 1, 16, 100, 0.03),
    ]
    for i, (m, C, warmup, thin, n, off, scale) in enumerate(ahmc_cases):
        d = m.dimension
        args = hmc_args(m, _slice3_start(m, C, 80 + i), 0xADA0 + i)
        leb, minv = frozen(C, d, scale) if scale else (None, None)
        kw = dict(n_leapfrog=N_LEAPFROG, warmup=warmup, thin=thin, n_samples=n,
                  da=DualAveraging(AHMC_EPS0, 0.65), log_eps_bar=leb, inverse_mass=minv,
                  iteration_offset=off)
        got = fused_adaptive_hmc_sample(*args, **kw)
        ref = adaptive_hmc_reference(*args, **kw)
        r = agreement(got[:5], ref[:5])  # draws + the frozen log ε̄ and M⁻¹
        g_ok = hold_gradient("adaptive_hmc", got[5], ref[5], got[0], ref[0], got[2], ref[2])
        print(f"kernel adaptive_hmc {m.cuda_density} d={d} C={C} warmup={warmup} thin={thin} "
              f"n={n} offset={off} resume={scale is not None}: {r} "
              f"final-gradient agree {g_ok:.5f}")
        check_agreement("adaptive_hmc", r, SHORT_RUN_CHAINS_MIN,
                        visible_steps=warmup == 0 and thin == 1)
        errs["adaptive_hmc"] = max(errs["adaptive_hmc"], r["max_abs_err"])

    adapt_cases = [  # (model, eps0, C, warmup, thin, n, offset, resume)
        (flag, 1.0, 4096, 40, 1, 24, 0, False),
        (corr, 10.0, 4000, 40, 3, 11, (1 << 32) - 30, False),
        (flag, 1.0, 3001, 0, 2, 20, 11, True),
        (corr, 10.0, 4096, 0, 1, 64, 0, True),
    ]
    for i, (m, eps0, C, warmup, thin, n, off, resume) in enumerate(adapt_cases):
        p = _slice3_start(m, C, 90 + i)
        leb = (torch.tensor(np.log(rng.uniform(0.3, 3.0, (1, C))), dtype=torch.float32,
                            device=DEVICE) if resume else None)
        args = (m.tile_density, m.cuda_density, p, m.tile_density(p, *m.tile_consts),
                m.tile_consts, 0xADB0 + i)
        kw = dict(warmup=warmup, thin=thin, n_samples=n, da=DualAveraging(eps0, 0.352),
                  log_eps_bar=leb, iteration_offset=off)
        r = agreement(fused_adapt_rwmh_sample(*args, **kw), adapt_rwmh_reference(*args, **kw))
        print(f"kernel adapt_rwmh {m.cuda_density} eps0={eps0} C={C} warmup={warmup} "
              f"thin={thin} n={n} offset={off} resume={resume}: {r}")
        check_agreement("adapt_rwmh", r, SHORT_RUN_CHAINS_MIN,
                        visible_steps=warmup == 0 and thin == 1)
        errs["adapt_rwmh"] = max(errs["adapt_rwmh"], r["max_abs_err"])

    # the logistic regression's hand-tuned yardsticks on the PR 1-2 kernels
    p = _logreg_start(LOGREG_CHAINS, 99)
    lp = lr.tile_density(p, *lr.tile_consts)
    args = (lr.tile_density, lr.cuda_density, p, lp, LOGREG_RWMH_SCALE, lr.tile_consts, 0x1A)
    kw = dict(burn=0, thin=1, n_samples=64)
    r = agreement(fused_rwmh_sample(*args, **kw), rwmh_sample_reference(*args, **kw))
    print(f"kernel rwmh_sample logistic_regression d=32 scale={LOGREG_RWMH_SCALE} "
          f"C={LOGREG_CHAINS} n=64: {r}")
    check_agreement("rwmh_sample", r, SHORT_RUN_CHAINS_MIN, visible_steps=True)
    errs["rwmh_sample"] = max(errs["rwmh_sample"], r["max_abs_err"])
    args = mala_args(lr, p, 0x1B)
    kw = dict(step_size_sq=LOGREG_MALA_S2, burn=0, thin=1, n_samples=64)
    got, ref = fused_mala_sample(*args, **kw), mala_sample_reference(*args, **kw)
    r = agreement(got[:3], ref[:3])
    hold_gradient("mala", got[3], ref[3], got[0], ref[0], got[2], ref[2])
    print(f"kernel mala logistic_regression d=32 s2={LOGREG_MALA_S2} C={LOGREG_CHAINS} "
          f"n=64: {r}")
    check_agreement("mala", r, SHORT_RUN_CHAINS_MIN, visible_steps=True)
    errs["mala"] = max(errs["mala"], r["max_abs_err"])
    sync()


def compare_means(path, summary, ref, names):
    """Posterior means within 4 combined MCSE of the reference run's, per
    coordinate."""
    worst = max(abs(summary[n]["mean"] - ref[n]["mean"])
                / (summary[n]["mcse"] ** 2 + ref[n]["mcse"] ** 2) ** 0.5 for n in names)
    print(f"{path}: largest |mean - engine=torch mean| / combined MCSE = {worst:.3f}")
    check(worst < 4.0, f"{path}: a posterior mean is {worst:.2f} combined MCSE from "
                       "the engine='torch' run's")


def phase_main_logreg(model, label, launches):
    """AdaptiveHMC(n_leapfrog=8, initial_step_size=0.05) on the d = 32
    logistic regression at 8192 × (500 + 4000) (bench.py's harness), then
    HamiltonianMC at the adapted median (ε̄, M⁻¹) on the same target, each
    held against an engine="torch" AdaptiveHMC run."""
    from advancedmh_tpu_torch import AdaptiveHMC, HamiltonianMC, ess_bulk, sample

    names = [f"β{j}" for j in range(32)]
    init = torch.zeros(32, device=DEVICE)
    spl = AdaptiveHMC(n_leapfrog=N_LEAPFROG, initial_step_size=AHMC_EPS0)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    result = sample(model, spl, N_DRAWS, num_chains=LOGREG_CHAINS, engine="fused",
                    num_warmup=N_WARM, discard_initial=N_WARM, initial_params=init,
                    key=KEY + 40)
    chains = result.to_chains(param_names=names)
    summary = chains.summary()
    sync()
    t_path = time.perf_counter() - t0
    got = read_launches()
    check_launches("adaptive hmc main path", got, {"adaptive_hmc": 1})
    launches["adaptive_hmc"] = got["adaptive_hmc"]
    check(chains.values.shape == (N_DRAWS, 32, LOGREG_CHAINS), "adaptive hmc Chains shape")
    check(bool(torch.isfinite(chains.values).all()), "adaptive hmc: non-finite draws")
    acc = float(result.transitions.accepted.float().mean())
    rhat = max(summary[n]["rhat"] for n in names)
    eps = torch.exp(result.final_state.log_eps_bar)
    minv_med = result.final_state.inverse_mass.median(0).values  # (32,)
    med_eps, med_minv = float(eps.median()), float(minv_med.median())
    ess_b0 = float(ess_bulk(chains["β0"]))
    print(f"[{label}] adaptive hmc first sample(engine='fused') + summary {t_path:.4f} s; "
          f"acceptance {acc:.4f}; max R-hat {rhat:.5f}; median eps-bar {med_eps:.6f}; "
          f"median M^-1 {med_minv:.4f} (per coordinate {minv_med.min():.4f}.."
          f"{minv_med.max():.4f}); ess_bulk(β0)={ess_b0:.1f}, "
          f"ESS/s(β0) incl. summary {ess_b0 / t_path:.6e}")
    check(rhat < 1.01, f"adaptive hmc: R-hat {rhat} >= 1.01")
    check(0.1 < acc < 0.99, f"adaptive hmc acceptance {acc}")
    # bench.py measured σ̂ ≈ 1.07 per coordinate from the adapted inverse
    # mass: the median M⁻¹ (a variance) must lie in [0.5, 2.5]
    check(0.5 <= med_minv <= 2.5, f"adaptive hmc median M^-1 {med_minv} outside [0.5, 2.5]")

    t0 = time.perf_counter()
    ref = sample(model, spl, N_REF_DRAWS, num_chains=N_REF_CHAINS, engine="torch",
                 num_warmup=N_WARM, discard_initial=N_WARM, initial_params=init, key=KEY + 41,
                 chain_type="chains", param_names=names)
    ref_summary = ref.summary()
    sync()
    print(f"[{label}] engine=torch AdaptiveHMC {N_REF_CHAINS} x ({N_WARM} + {N_REF_DRAWS}): "
          f"{time.perf_counter() - t0:.4f} s")
    compare_means("adaptive hmc", summary, ref_summary, names)

    reset_launches()
    sync()
    t0 = time.perf_counter()
    hres = sample(model, HamiltonianMC(med_eps, N_LEAPFROG, inverse_mass=minv_med), N_DRAWS,
                  num_chains=LOGREG_CHAINS, engine="fused", discard_initial=N_WARM,
                  initial_params=init, key=KEY + 42)
    hchains = hres.to_chains(param_names=names)
    hsummary = hchains.summary()
    sync()
    t_hmc = time.perf_counter() - t0
    got = read_launches()
    check_launches("hmc main path", got, {"hmc": 1})
    launches["hmc"] = got["hmc"]
    hacc = float(hres.transitions.accepted.float().mean())
    hrhat = max(hsummary[n]["rhat"] for n in names)
    ess_h = float(ess_bulk(hchains["β0"]))
    print(f"[{label}] hmc at the adapted (eps, M^-1) first sample + summary {t_hmc:.4f} s; "
          f"acceptance {hacc:.4f}; max R-hat {hrhat:.5f}; ess_bulk(β0)={ess_h:.1f}, "
          f"ESS/s(β0) incl. summary {ess_h / t_hmc:.6e}")
    check(bool(torch.isfinite(hchains.values).all()), "hmc: non-finite draws")
    check(hrhat < 1.01, f"hmc: R-hat {hrhat} >= 1.01")
    check(0.1 < hacc < 0.99, f"hmc acceptance {hacc}")
    compare_means("hmc", hsummary, ref_summary, names)
    return med_eps, minv_med, ref_summary


def phase_main_adapt(model, label, launches):
    """StepSizeAdaptation.rwmh(2, initial_step_size=1.0) on the flagship at
    16384 × (500 + 4000) (bench.py:241-253)."""
    from advancedmh_tpu_torch import StepSizeAdaptation, sample
    from advancedmh_tpu_torch.samplers import optimal_rwmh_accept

    spl = StepSizeAdaptation.rwmh(2, initial_step_size=1.0, device=DEVICE)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    result = sample(model, spl, N_DRAWS, num_chains=N_CHAINS, engine="fused",
                    num_warmup=N_WARM, discard_initial=N_WARM, initial_params=[0.0, 1.0],
                    key=KEY + 50)
    chains = result.to_chains(param_names=["μ", "σ"])
    summary = chains.summary()
    sync()
    t_path = time.perf_counter() - t0
    got = read_launches()
    check_launches("adapt rwmh main path", got, {"adapt_rwmh": 1})
    launches["adapt_rwmh"] = got["adapt_rwmh"]
    acc = float(result.transitions.accepted.float().mean())
    eps = torch.exp(result.final_state.log_eps_bar)
    print(f"adapt rwmh summary: {json.dumps(summary)}; acceptance {acc:.4f} "
          f"(target {optimal_rwmh_accept(2)}); median eps-bar {float(eps.median()):.5f}; "
          f"first sample+summary {t_path:.4f} s")
    check(chains.values.shape == (N_DRAWS, 2, N_CHAINS), "adapt rwmh Chains shape")
    check(bool(torch.isfinite(chains.values).all()), "adapt rwmh: non-finite draws")
    mu_q, sig_q = grid_posterior_means(model.tile_consts[0].cpu().numpy().ravel())
    posterior_check("adapt rwmh", summary, mu_q, sig_q)
    check(abs(acc - optimal_rwmh_accept(2)) < 0.08, f"adapt rwmh acceptance {acc}")


def phase_slice3_checks(models):
    """tests/test_pallas.py's card-only checks of the three samplers, at
    their shapes, and split runs of the adaptive kernels (bit for bit)."""
    from advancedmh_tpu_torch import AdaptiveHMC, HamiltonianMC, StepSizeAdaptation, sample

    sig = np.array([[1.5, 0.35], [0.35, 1.0]])
    corr, flag = models["corr"], models["flagship"]

    def draws_of(res):
        return res.transitions.params.reshape(-1, 2).double().cpu().numpy()

    spl = StepSizeAdaptation.rwmh(2, initial_step_size=10.0, device=DEVICE)
    res = sample(corr, spl, 4000, key=11, num_chains=N_CHECK, engine="fused", num_warmup=1500,
                 discard_initial=1500, initial_params=[0.0, 0.0])
    d, acc = draws_of(res), float(res.transitions.accepted.float().mean())
    eps = torch.exp(res.final_state.log_eps_bar).cpu().numpy()
    print(f"adapt rwmh correlated {N_CHECK}x(1500+4000) from eps0=10: acceptance {acc:.4f} "
          f"mean {d.mean(0).tolist()} cov {np.cov(d.T).tolist()} median eps-bar "
          f"{np.median(eps):.4f} cv {eps.std() / eps.mean():.4f}")
    check(abs(acc - spl.target_accept) < 0.08, "adapt rwmh correlated acceptance")
    check(np.allclose(d.mean(0), 0.0, atol=0.05), "adapt rwmh correlated mean")
    check(np.allclose(np.cov(d.T), sig, atol=0.15), "adapt rwmh correlated covariance")
    check(eps.shape == (N_CHECK,) and 0.5 < np.median(eps) < 4.0 and eps.std() / eps.mean() < 0.5,
          "adapt rwmh correlated eps-bar band")
    res = sample(flag, StepSizeAdaptation.rwmh(2, device=DEVICE), 200, key=12, num_chains=1024,
                 engine="fused", num_warmup=600, discard_initial=600, thinning=3,
                 initial_params=[0.0, 1.0])
    check(tuple(res.transitions.lp.shape) == (1024, 200), "adapt rwmh thinning shape")
    check(abs(float(res.transitions.params[..., 0].mean())) < 0.1, "adapt rwmh thinning mean")

    res = sample(corr, HamiltonianMC(0.4, 8), 2000, key=21, num_chains=N_CHECK, engine="fused",
                 discard_initial=500, initial_params=[1.0, 1.0])
    d, acc = draws_of(res), float(res.transitions.accepted.float().mean())
    x = res.final_state.params.double().cpu().numpy()
    grad_err = np.abs(res.final_state.gradient.double().cpu().numpy()
                      + (np.linalg.inv(sig) @ x.T).T).max()
    print(f"hmc(0.4, 8) correlated {N_CHECK}x2000: acceptance {acc:.4f} mean "
          f"{d.mean(0).tolist()} cov {np.cov(d.T).tolist()} final-gradient |err| {grad_err:.3g}")
    check(acc > 0.8, "hmc correlated acceptance")
    check(np.allclose(d.mean(0), 0.0, atol=0.05), "hmc correlated mean")
    check(np.allclose(np.cov(d.T), sig, atol=0.1), "hmc correlated covariance")
    check(grad_err < 1e-3 * (1 + np.abs(x).max()), "hmc correlated final gradient")
    res = sample(models["diag9"], HamiltonianMC(0.5, 6, inverse_mass=[9.0, 1.0]), 600, key=22,
                 num_chains=1024, engine="fused", discard_initial=300, thinning=3,
                 initial_params=[0.0, 0.0])
    d = draws_of(res)
    print(f"hmc(0.5, 6, M^-1=[9, 1]) thin 3, 1024x600: mean {d.mean(0).tolist()} "
          f"var {d.var(0).tolist()}")
    check(tuple(res.transitions.params.shape) == (1024, 600, 2), "hmc thinning shape")
    check(np.allclose(d.mean(0), 0.0, atol=0.15), "hmc thinning mean")
    check(np.allclose(d.var(0), [9.0, 1.0], rtol=0.1), "hmc thinning variance")

    cov = np.diag([25.0, 1.0])
    for pooled, warm in ((False, 500), (True, 400)):
        res = sample(models["aniso"], AdaptiveHMC(n_leapfrog=8, initial_step_size=0.05,
                                                  pooled=pooled),
                     1000, key=30 + pooled, num_chains=N_CHECK, engine="fused", num_warmup=warm,
                     discard_initial=warm, initial_params=[0.0, 0.0])
        d, acc = draws_of(res), float(res.transitions.accepted.float().mean())
        im = res.final_state.inverse_mass.double().cpu().numpy()
        spread = float(np.ptp(im, axis=0).max())
        print(f"adaptive hmc{' pooled' if pooled else ''} diag(25, 1) {N_CHECK}x({warm}+1000): "
              f"acceptance {acc:.4f} mean {d.mean(0).tolist()} cov {np.cov(d.T).tolist()} "
              f"median M^-1 {np.median(im, 0).tolist()} spread {spread:.3g}")
        check(np.allclose(d.mean(0) / np.sqrt(np.diag(cov)), 0.0, atol=0.1), "ahmc mean")
        check(np.allclose(np.cov(d.T), cov, rtol=0.15, atol=0.1), "ahmc covariance")
        check(np.allclose(np.median(im, 0), np.diag(cov), rtol=0.5), "ahmc median M^-1")
        check(0.5 < acc < (0.99 if pooled else 0.95), f"ahmc acceptance {acc}")
        if pooled:
            check(spread < 1e-5, f"pooled ahmc: M^-1 spread {spread} >= 1e-5")

    # split runs: warmup + 2N in one call = warmup + N, then N resumed
    split = [
        ("adapt rwmh", flag, StepSizeAdaptation.rwmh(2, initial_step_size=2.0, device=DEVICE),
         [0.0, 1.0], 300),
        ("adaptive hmc", models["aniso"], AdaptiveHMC(n_leapfrog=8, initial_step_size=0.05),
         [0.0, 0.0], 200),
    ]
    for name, m, spl, init, n in split:
        kw = dict(num_chains=N_CHECK, engine="fused", key=KEY + 60)
        whole = sample(m, spl, 2 * n, num_warmup=N_WARM, discard_initial=N_WARM,
                       initial_params=init, **kw)
        first = sample(m, spl, n, num_warmup=N_WARM, discard_initial=N_WARM,
                       initial_params=init, **kw)
        rest = sample(m, spl, n, num_warmup=0, discard_initial=1,
                      initial_state=first.final_state, iteration_offset=N_WARM + n, **kw)
        same = (torch.equal(torch.cat([first.transitions.params, rest.transitions.params], 1),
                            whole.transitions.params)
                and torch.equal(torch.cat([first.transitions.lp, rest.transitions.lp], 1),
                                whole.transitions.lp)
                and torch.equal(rest.final_state.log_eps_bar, whole.final_state.log_eps_bar))
        print(f"{name} split run {N_CHECK} chains, {N_WARM} warmup + {n} + {n}: "
              f"bit-exact {same}")
        check(same, f"{name}: the split run differs from the unsplit one")
    sync()


def phase_timing_slice3(models, label, errs, times, med_eps, minv_med):
    """The three kernels at their paths' shapes (best of 3), the plain
    versions at the paths' widths over shorter runs, held against them."""
    from advancedmh_tpu_torch.ops import (DualAveraging, adapt_rwmh_reference,
                                          adaptive_hmc_reference, fused_adapt_rwmh_sample,
                                          fused_adaptive_hmc_sample, fused_hmc_sample,
                                          hmc_sample_reference, minv_column)

    lr, flag = models["logreg"], models["flagship"]
    C = LOGREG_CHAINS
    args = hmc_args(lr, torch.zeros(32, C, device=DEVICE), KEY)
    da = DualAveraging(AHMC_EPS0, 0.65)
    kw = dict(n_leapfrog=N_LEAPFROG, warmup=N_WARM, thin=1, n_samples=N_DRAWS, da=da)
    t_k, out = best_of(lambda: fused_adaptive_hmc_sample(*args, **kw))
    acc = float(out[2].mean())
    del out
    short = dict(n_leapfrog=N_LEAPFROG, warmup=N_PLAIN_HMC // 2, thin=1,
                 n_samples=N_PLAIN_HMC // 2, da=da)
    t_ks, out = best_of(lambda: fused_adaptive_hmc_sample(*args, **short))
    t_p, ref = best_of(lambda: adaptive_hmc_reference(*args, **short))
    steps = N_WARM + N_DRAWS
    print(f"[{label}] adaptive_hmc logistic regression at {C} x ({N_WARM} + {N_DRAWS}), "
          f"L={N_LEAPFROG}: kernel {t_k * 1e3:.4f} ms ({C * steps / t_k:.6e} chain-steps/s, "
          f"acceptance {acc:.4f}); at {C} x ({N_PLAIN_HMC // 2} + {N_PLAIN_HMC // 2}): kernel "
          f"{t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
    hold(errs, "adaptive_hmc", f"{C} x {N_PLAIN_HMC}", out[:5], ref[:5])
    times["adaptive_hmc"] = (t_k, t_p, bound_hmc(C, steps, N_DRAWS, N_WARM, 32, 256),
                             f"plain at {C} x {N_PLAIN_HMC} steps")
    del out, ref

    minv = minv_column(minv_med, 32, DEVICE)
    kw = dict(step_size=med_eps, n_leapfrog=N_LEAPFROG, inverse_mass=minv, burn=N_WARM - 1,
              thin=1, n_samples=N_DRAWS)
    t_k, out = best_of(lambda: fused_hmc_sample(*args, **kw))
    del out
    short = dict(kw, burn=0, n_samples=N_PLAIN_HMC)
    t_ks, out = best_of(lambda: fused_hmc_sample(*args, **short))
    t_p, ref = best_of(lambda: hmc_sample_reference(*args, **short))
    steps = N_WARM - 1 + N_DRAWS
    print(f"[{label}] hmc logistic regression at {C} x ({N_WARM - 1} + {N_DRAWS}), "
          f"L={N_LEAPFROG}: kernel {t_k * 1e3:.4f} ms ({C * steps / t_k:.6e} chain-steps/s); "
          f"at {C} x {N_PLAIN_HMC}: kernel {t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
    hold(errs, "hmc", f"{C} x {N_PLAIN_HMC}", out[:3], ref[:3])
    times["hmc"] = (t_k, t_p, bound_hmc(C, steps, N_DRAWS, 0, 32, 256),
                    f"plain at {C} x {N_PLAIN_HMC} steps")
    del out, ref

    p0 = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, N_CHAINS).contiguous()
    args = (flag.tile_density, flag.cuda_density, p0, flag.tile_density(p0, *flag.tile_consts),
            flag.tile_consts, KEY)
    kw = dict(warmup=N_WARM, thin=1, n_samples=N_DRAWS, da=DualAveraging(1.0, 0.352))
    t_k, out = best_of(lambda: fused_adapt_rwmh_sample(*args, **kw))
    del out
    short = dict(kw, warmup=50, n_samples=450)
    t_ks, out = best_of(lambda: fused_adapt_rwmh_sample(*args, **short))
    t_p, ref = best_of(lambda: adapt_rwmh_reference(*args, **short))
    print(f"[{label}] adapt_rwmh flagship at {N_CHAINS} x ({N_WARM} + {N_DRAWS}): kernel "
          f"{t_k * 1e3:.4f} ms ({N_CHAINS * (N_WARM + N_DRAWS) / t_k:.6e} chain-steps/s); at "
          f"{N_CHAINS} x (50 + 450): kernel {t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
    hold(errs, "adapt_rwmh", f"{N_CHAINS} x (50 + 450)", out, ref)
    times["adapt_rwmh"] = (t_k, t_p, bound("adapt_rwmh", C=N_CHAINS, steps=N_DRAWS,
                                           emitted=N_DRAWS, warmup=N_WARM),
                           f"plain at {N_CHAINS} x (50 + 450) steps")
    del out, ref


# ---- slice 4: ChEES-HMC and MEADS ----------------------------------------------------------

# bench.py's rows: ChEES (bench.py:440-449) and MEADS(n_folds=2) (bench.py:422-437,
# 475-493) on the d = 32 logistic regression and Neal's funnel, 8192 chains.
CHEES = dict(initial_step_size=0.1, initial_trajectory_length=1.0, max_leapfrog=16)
N_PLAIN_SLICE4 = 10  # steps of the slice-4 plain versions timed at 8192 chains
MEADS_WIDE_CHAINS = 65536  # MEADS held at a chain count no cooperative launch takes
MEADS_WIDE_STEPS = 4


def _slice4_start(m, C: int, seed: int):
    if m.cuda_density == "neal_funnel":
        return _gauss_start(10, C, seed)
    return _slice3_start(m, C, seed)


def _tile_equal(name, got, ref):
    """Per-tile outputs of the warmup kernel: bit for bit, else within
    1e-4 relative (printing why)."""
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    close = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in zip(got, ref))
    if not same:
        print(f"{name}: the per-tile statistics are not bit-equal (a decision parted); "
              f"within 1e-4: {close}")
    check(close, f"{name}: the per-tile statistics differ from the plain version's")
    return same


def phase_kernels_slice4(models, errs):
    """The ChEES warmup and frozen kernels and MEADS against their plain
    versions at 64-step cases: the logistic regression at 1024 chains, the
    funnel and the correlated Gaussian at 2048, each pooled over the JAX
    rule's tiles."""
    from advancedmh_tpu_torch import ChEESHMC
    from advancedmh_tpu_torch.ops import (CheesParams, MeadsParams, chees_frozen_reference,
                                          chees_warmup_reference, fused_chees_frozen_sample,
                                          fused_chees_warmup_block, fused_meads_sample,
                                          halton_trips, meads_reference, vdc)
    from advancedmh_tpu_torch.runtime.fused import (CHEES_WARMUP_BUDGET, MAX_TILE,
                                                    MEADS_BUDGET, fused_tile)

    for i, (key, C, eps0) in enumerate((("logreg", 1024, 0.1), ("funnel", 2048, 0.2),
                                        ("corr", 2048, 0.1))):
        m = models[key]
        d = m.dimension
        p = _slice4_start(m, C, 100 + i)
        lp, g = m.tile_value_and_grad(p, *m.tile_consts)
        args = (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 0xC4EE + i)
        spl = ChEESHMC(initial_step_size=eps0, initial_trajectory_length=1.0, max_leapfrog=16)
        us = tuple(vdc(j + 1) for j in range(16))
        trips = tuple(max(1, min(16, round(u / eps0))) for u in us)
        sv = torch.tensor([np.log(eps0)] * 2 + [0.0] * 5 + [1.0, 0.0], dtype=torch.float32,
                          device=DEVICE)
        tile = fused_tile(C, MAX_TILE, d, CHEES_WARMUP_BUDGET)
        kw = dict(trips=trips, us=us, n_groups=4, sv=sv,
                  inverse_mass=torch.ones(d, 1, device=DEVICE), params=CheesParams.of(spl),
                  tile_chains=tile, iteration_offset=7)
        got = fused_chees_warmup_block(*args, **kw)
        ref = chees_warmup_reference(*args, **kw)
        r = agreement((got[0][None], got[1][None], got[3][None], got[2]),
                      (ref[0][None], ref[1][None], ref[3][None], ref[2]))
        tiles = _tile_equal("chees_warmup", got[4:], ref[4:])
        print(f"kernel chees_warmup {m.cuda_density} d={d} C={C} tile={tile} 64 steps: {r}; "
              f"per-tile sv, sum x, sum x^2 identical {tiles}")
        check_agreement("chees_warmup", r, SHORT_RUN_CHAINS_MIN, visible_steps=False)
        errs["chees_warmup"] = max(errs["chees_warmup"], r["max_abs_err"])

        kw = dict(trips=halton_trips(5, 32, 16), phase=3,
                  step_size=torch.full((1, 1), 0.5 * eps0, device=DEVICE),
                  inverse_mass=torch.linspace(0.5, 1.5, d, device=DEVICE)[:, None], thin=2,
                  n_samples=32, iteration_offset=(1 << 32) - 40)
        got = fused_chees_frozen_sample(*args, **kw)
        ref = chees_frozen_reference(*args, **kw)
        r = agreement(got[:3], ref[:3])
        g_ok = hold_gradient("chees_frozen", got[3], ref[3], got[0], ref[0], got[2], ref[2])
        print(f"kernel chees_frozen {m.cuda_density} d={d} C={C} 64 trajectories, thin 2: {r} "
              f"final-gradient agree {g_ok:.5f}")
        check_agreement("chees_frozen", r, SHORT_RUN_CHAINS_MIN, visible_steps=False)
        errs["chees_frozen"] = max(errs["chees_frozen"], r["max_abs_err"])

        rng = np.random.default_rng(110 + i)
        mom = torch.tensor(rng.normal(size=(d, C)), dtype=torch.float32, device=DEVICE)
        u = torch.tensor(rng.uniform(size=(1, C)), dtype=torch.float32, device=DEVICE)
        margs = (m.tile_value_and_grad, m.cuda_density, p, lp, g, mom, u, m.tile_consts,
                 0x3EAD + i)
        tile = fused_tile(C, MAX_TILE, d, MEADS_BUDGET)
        kw = dict(n_folds=2, t0=1, burn=0, thin=1, n_samples=64, params=MeadsParams(),
                  tile_chains=tile)
        got = fused_meads_sample(*margs, **kw)
        ref = meads_reference(*margs, **kw)
        r = agreement(got, ref)  # draws + the final x, lp, gradient, p and u
        print(f"kernel meads {m.cuda_density} d={d} C={C} tile={tile} K=2 64 steps: {r}")
        check_agreement("meads", r, SHORT_RUN_CHAINS_MIN, visible_steps=True)
        errs["meads"] = max(errs["meads"], r["max_abs_err"])

    # a chain count the parent's cooperative launch refused: 64 tiles of 1024
    # on the logistic regression, one cluster of 16 blocks each
    m, C = models["logreg"], MEADS_WIDE_CHAINS
    p = _slice4_start(m, C, 120)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    rng = np.random.default_rng(121)
    mom = torch.tensor(rng.normal(size=(32, C)), dtype=torch.float32, device=DEVICE)
    u = torch.tensor(rng.uniform(size=(1, C)), dtype=torch.float32, device=DEVICE)
    margs = (m.tile_value_and_grad, m.cuda_density, p, lp, g, mom, u, m.tile_consts, 0x3EB0)
    tile = fused_tile(C, MAX_TILE, 32, MEADS_BUDGET)
    kw = dict(n_folds=2, t0=1, burn=0, thin=1, n_samples=MEADS_WIDE_STEPS, params=MeadsParams(),
              tile_chains=tile)
    got = fused_meads_sample(*margs, **kw)
    ref = meads_reference(*margs, **kw)
    r = agreement(got, ref)
    print(f"kernel meads logistic_regression d=32 C={C} tile={tile} K=2 {MEADS_WIDE_STEPS} "
          f"steps: {r}")
    check_agreement("meads", r, SHORT_RUN_CHAINS_MIN, visible_steps=True)
    errs["meads"] = max(errs["meads"], r["max_abs_err"])
    sync()


def _logreg_path(model, sampler, key, **kw):
    from advancedmh_tpu_torch import sample

    names = [f"β{j}" for j in range(32)]
    reset_launches()
    sync()
    t0 = time.perf_counter()
    result = sample(model, sampler, N_DRAWS, num_chains=LOGREG_CHAINS, engine="fused",
                    discard_initial=N_WARM, initial_params=torch.zeros(32, device=DEVICE),
                    key=key, **kw)
    chains = result.to_chains(param_names=names)
    summary = chains.summary()
    sync()
    return result, chains, summary, time.perf_counter() - t0, read_launches()


def phase_main_chees_meads(models, label, launches, ref_summary):
    """ChEESHMC (bench.py:440-449) and MEADS(n_folds=2) (bench.py:422-437) on
    the d = 32 logistic regression at 8192 × (500 + 4000), each held against
    slice 3's engine="torch" AdaptiveHMC run (the same posterior), then
    MEADS(n_folds=2) on the funnel at 8192 chains (bench.py:475-493)."""
    from advancedmh_tpu_torch import MEADS, ChEESHMC, ess_bulk, sample

    lr, names = models["logreg"], [f"β{j}" for j in range(32)]
    result, chains, summary, t_path, got = _logreg_path(lr, ChEESHMC(**CHEES), KEY + 70,
                                                        num_warmup=N_WARM)
    check(1 <= got["chees_warmup"] <= 3, f"chees warmup launches {got['chees_warmup']}")
    check_launches("chees main path", got,
                   {"chees_warmup": got["chees_warmup"], "chees_frozen": 1})
    launches.update(chees_warmup=got["chees_warmup"], chees_frozen=got["chees_frozen"])
    st = result.final_state
    eps, T = float(torch.exp(st.log_eps_bar[0])), float(torch.exp(st.log_traj_bar[0]))
    acc = float(result.transitions.accepted.float().mean())
    rhat = max(summary[n]["rhat"] for n in names)
    ess_b0 = float(ess_bulk(chains["β0"]))
    print(f"[{label}] chees first sample(engine='fused') + summary {t_path:.4f} s; acceptance "
          f"{acc:.4f}; max R-hat {rhat:.5f}; eps-bar {eps:.6f}, T-bar {T:.6f}, ratio "
          f"{T / eps:.4f}; median M^-1 {float(st.inverse_mass[0].median()):.4f}; "
          f"ess_bulk(β0)={ess_b0:.1f}, ESS/s(β0) incl. summary {ess_b0 / t_path:.6e}")
    check(bool(torch.isfinite(chains.values).all()), "chees: non-finite draws")
    check(chains.values.shape == (N_DRAWS, 32, LOGREG_CHAINS), "chees Chains shape")
    check(rhat < 1.01, f"chees: R-hat {rhat} >= 1.01")
    check(0.2 < acc < 0.99, f"chees acceptance {acc}")
    compare_means("chees", summary, ref_summary, names)

    result, chains, summary, t_path, got = _logreg_path(lr, MEADS(n_folds=2), KEY + 71)
    check_launches("meads main path", got, {"meads": 1})
    launches["meads"] = got["meads"]
    acc = float(result.transitions.accepted.float().mean())
    rhat = max(summary[n]["rhat"] for n in names)
    ess_b0 = float(ess_bulk(chains["β0"]))
    print(f"[{label}] meads first sample(engine='fused') + summary {t_path:.4f} s; acceptance "
          f"{acc:.4f}; max R-hat {rhat:.5f}; ess_bulk(β0)={ess_b0:.1f}, ESS/s(β0) incl. "
          f"summary {ess_b0 / t_path:.6e}; final iteration {int(result.final_state.iteration[0])}")
    check(bool(torch.isfinite(chains.values).all()), "meads: non-finite draws")
    check(rhat < 1.01, f"meads: R-hat {rhat} >= 1.01")
    check(0.5 < acc <= 1.0, f"meads acceptance {acc}")
    check(int(result.final_state.iteration[0]) == 1 + N_WARM - 1 + N_DRAWS,
          "meads: the final iteration is not the steps run")
    compare_means("meads", summary, ref_summary, names)

    reset_launches()
    sync()
    t0 = time.perf_counter()
    res = sample(models["funnel"], MEADS(n_folds=2), N_DRAWS, num_chains=LOGREG_CHAINS,
                 engine="fused", discard_initial=N_WARM,
                 initial_params=torch.zeros(10, device=DEVICE), key=KEY + 72)
    sync()
    t_f = time.perf_counter() - t0
    check_launches("meads funnel path", read_launches(), {"meads": 1})
    v = res.transitions.params[:, :, 0]
    print(f"[{label}] meads funnel d=10 {LOGREG_CHAINS} x ({N_WARM} + {N_DRAWS}): {t_f:.4f} s; "
          f"acceptance {float(res.transitions.accepted.float().mean()):.4f}; mean v "
          f"{float(v.mean()):.4f}, P(v < -2) {float((v < -2).float().mean()):.4f} "
          f"(N(0, 9): 0.2525)")
    check(bool(torch.isfinite(res.transitions.lp).all()), "meads funnel: non-finite lp")
    check(bool(torch.isfinite(res.transitions.params).all()), "meads funnel: non-finite draws")


def phase_slice4_checks(models):
    """tests/test_pallas.py's card-only ChEES and MEADS checks at their
    shapes; sample_chunked is not ported, so the chunked tests are split
    runs through initial_state + iteration_offset, held bit for bit."""
    from advancedmh_tpu_torch import MEADS, ChEESHMC, Schedule, sample
    from advancedmh_tpu_torch.runtime.fused import (CHEES_WARMUP_BUDGET, MAX_TILE,
                                                    fused_tile, sample_fused_chees)

    SIG = np.array([[1.5, 0.35], [0.35, 1.0]])
    SIG2 = np.array([[1.0, 0.5], [0.5, 1.0]])
    corr, corr2 = models["corr"], models["corr_ram"]
    zeros = torch.zeros(2, device=DEVICE)

    def draws_of(tr):
        return tr.params.reshape(-1, 2).double().cpu().numpy()

    def moments(name, d, sig, atol_mean, **cov_tol):
        mean, cov = d.mean(0), np.cov(d.T)
        print(f"{name}: mean {mean.tolist()} cov {cov.tolist()}")
        check(np.allclose(mean, 0.0, atol=atol_mean), f"{name}: mean")
        check(np.allclose(cov, sig, **cov_tol), f"{name}: covariance")

    # MEADS (tests/test_pallas.py:1275-1347)
    res = sample(corr, MEADS(), 2000, key=0, num_chains=N_CHECK, engine="fused",
                 discard_initial=500, initial_params=zeros)
    acc = float(res.transitions.accepted.float().mean())
    u = res.final_state.u
    print(f"meads correlated {N_CHECK}x(500+2000): acceptance {acc:.4f}")
    moments("meads correlated", draws_of(res.transitions), SIG, 0.05, rtol=0.08, atol=0.04)
    check(0.8 < acc <= 1.0 and bool(((u >= 0) & (u < 1)).all()), "meads acceptance / u")
    res = sample(models["aniso"], MEADS(n_folds=2), 1000, key=1, num_chains=N_CHECK,
                 engine="fused", discard_initial=1000, thinning=2, initial_params=zeros)
    var = draws_of(res.transitions).var(0)
    print(f"meads n_folds=2 thin 2 diag(25, 1): var {var.tolist()}")
    check(tuple(res.transitions.params.shape) == (N_CHECK, 1000, 2), "meads thinning shape")
    check(np.allclose(var, [25.0, 1.0], rtol=0.1), "meads diag(25, 1) variance")
    kw = dict(key=2, num_chains=N_CHECK, engine="fused")
    whole = sample(corr2, MEADS(), 2000, discard_initial=500, initial_params=zeros, **kw)
    first = sample(corr2, MEADS(), 1000, discard_initial=500, initial_params=zeros, **kw)
    rest = sample(corr2, MEADS(), 1000, discard_initial=1, initial_state=first.final_state, **kw)
    same = all(torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f)) for f in ("params", "lp", "accepted"))
    st = rest.final_state
    print(f"meads split run {N_CHECK} chains, 500 + 1000 + 1000: bit-exact {same}, "
          f"iteration {int(st.iteration[0])}")
    check(same, "meads: the split run differs from the unsplit one")
    moments("meads split run", draws_of(whole.transitions), SIG2, 1.0, rtol=0.08, atol=0.04)
    check(int(st.iteration[0]) > 2000 and bool(((st.u >= 0) & (st.u < 1)).all()),
          "meads split run: iteration / u")

    # ChEES (tests/test_pallas.py:1351-1708)
    spl = ChEESHMC(initial_step_size=0.1, initial_trajectory_length=0.5, max_leapfrog=8)
    res = sample(corr, spl, 800, key=3, num_chains=N_CHECK, engine="fused", num_warmup=300,
                 discard_initial=300, initial_params=zeros)
    acc = float(res.transitions.accepted.float().mean())
    print(f"chees correlated {N_CHECK}x(300+800): acceptance {acc:.4f}")
    check(0.4 < acc < 0.95, f"chees acceptance {acc}")
    moments("chees correlated", draws_of(res.transitions), SIG, 0.06, atol=0.15)
    st = res.final_state
    check(bool(torch.isfinite(st.log_eps_bar).all() and torch.isfinite(st.log_traj_bar).all())
          and tuple(st.inner.params.shape) == (N_CHECK, 2), "chees final state")
    x0 = torch.tensor(np.random.default_rng(0).normal(size=(N_CHECK, 2)) * 0.1,
                      dtype=torch.float32, device=DEVICE)
    res = sample(corr, spl, 400, key=11, num_chains=N_CHECK, engine="fused", num_warmup=300,
                 discard_initial=300, thinning=2, initial_params=x0, initial_params_batched=True)
    moments("chees thin 2, batched init", draws_of(res.transitions), SIG, 0.07, atol=0.16)
    kw = dict(key=5, num_chains=N_CHECK, engine="fused")
    whole = sample(corr, spl, 800, num_warmup=300, discard_initial=300, initial_params=zeros,
                   **kw)
    first = sample(corr, spl, 400, num_warmup=300, discard_initial=300, initial_params=zeros,
                   **kw)
    rest = sample(corr, spl, 400, num_warmup=0, discard_initial=1,
                  initial_state=first.final_state, iteration_offset=700, **kw)
    same = all(torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f)) for f in ("params", "lp", "accepted"))
    print(f"chees split run {N_CHECK} chains, 300 warmup + 400 + 400: bit-exact {same}")
    check(same, "chees: the split run differs from the unsplit one")
    moments("chees split run", draws_of(whole.transitions), SIG, 0.06, atol=0.16)

    def adapted(st):
        return (float(torch.exp(st.log_eps_bar[0])), float(torch.exp(st.log_traj_bar[0])),
                st.inverse_mass[0].double().cpu().numpy())

    for C in (4096, 1000):  # the fused warmup lands the torch engine's regime
        kw = dict(key=9 if C == 4096 else 17, num_chains=C, initial_params=zeros)
        sched = Schedule(600, num_warmup=400)
        tr_f, st_f = sample_fused_chees(corr, spl, sched, warmup_engine="fused", **kw)
        tr_t, st_t = sample_fused_chees(corr, spl, sched, warmup_engine="torch", **kw)
        (eps_f, t_f, m_f), (eps_t, t_t, m_t) = adapted(st_f), adapted(st_t)
        print(f"chees {C} chains fused vs torch warmup: eps {eps_f:.4f} / {eps_t:.4f}, "
              f"T {t_f:.4f} / {t_t:.4f}, M^-1 {m_f.tolist()} / {m_t.tolist()}, n "
              f"{float(st_f.n[0])}")
        check(0.6 < eps_f / eps_t < 1.6 and 0.4 < t_f / t_t < 2.5, "chees fused warmup regime")
        check(np.allclose(m_f, m_t, rtol=0.35), "chees fused warmup M^-1")
        check(abs(float(st_f.n[0]) - C * 400) < 1, "chees fused warmup count")
        tol = dict(atol_mean=0.06 if C == 4096 else 0.08, atol=0.16 if C == 4096 else 0.2)
        for tr in (tr_f, tr_t):
            moments(f"chees {C} chains", draws_of(tr), SIG, tol["atol_mean"], atol=tol["atol"])
    res = sample(corr, ChEESHMC(initial_step_size=0.1, initial_trajectory_length=0.5,
                                max_leapfrog=8, adapt_mass=False), 500, key=22,
                 num_chains=N_CHECK, engine="fused", num_warmup=300, discard_initial=300,
                 initial_params=zeros)
    check(bool((res.final_state.inverse_mass == 1.0).all()), "chees adapt_mass=False: M^-1")
    moments("chees adapt_mass=False", draws_of(res.transitions), SIG, 0.06, atol=0.16)
    clock = {}
    tr, st = sample_fused_chees(corr, ChEESHMC(initial_step_size=0.01,
                                               initial_trajectory_length=0.01, max_leapfrog=16),
                                Schedule(600, num_warmup=500), key=3, num_chains=4096,
                                initial_params=zeros, stage_clock=clock)
    eps, t_bar, _ = adapted(st)
    print(f"chees bad init ratio: {len(clock['attempts'])} warmup launches, eps {eps:.4f}, "
          f"T/eps {t_bar / eps:.4f}")
    check(t_bar / eps < 8.0 and 0.5 < eps < 3.0, "chees bad init ratio did not recover")
    moments("chees bad init ratio", draws_of(tr), SIG, 0.06, atol=0.16)
    res = sample(corr, spl, 500, key=21, num_chains=8192, engine="fused", num_warmup=300,
                 discard_initial=300, initial_params=zeros)
    st = res.final_state
    im = st.inverse_mass.double().cpu().numpy()
    spread = max(float(st.log_eps_bar.max() - st.log_eps_bar.min()),
                 float(st.log_traj_bar.max() - st.log_traj_bar.min()), float(np.ptp(im, 0).max()))
    print(f"chees 8192 chains (tiles of {fused_tile(8192, MAX_TILE, 2, CHEES_WARMUP_BUDGET)}): "
          f"M^-1 {im[0].tolist()}, spread {spread:.3g}")
    moments("chees multi-tile", draws_of(res.transitions), SIG, 0.05, atol=0.15)
    check(spread < 1e-6 and np.allclose(im[0], np.diag(SIG), rtol=0.3)
          and 0.3 < float(torch.exp(st.log_eps_bar[0])) < 3.0, "chees multi-tile combine")
    res = sample(models["funnel"], ChEESHMC(initial_step_size=0.2, initial_trajectory_length=1.0,
                                            max_leapfrog=16), 600, key=2, num_chains=N_CHECK,
                 engine="fused", num_warmup=400, discard_initial=400,
                 initial_params=torch.zeros(10, device=DEVICE))
    v = res.transitions.params[:, :, 0]
    st = res.final_state
    print(f"chees funnel d=10 {N_CHECK}x(400+600): P(v < -2) {float((v < -2).float().mean()):.4f}"
          f", mean v {float(v.mean()):.4f}")
    check(bool(torch.isfinite(res.transitions.lp).all()) and bool(
        torch.isfinite(st.log_eps_bar).all() and torch.isfinite(st.log_traj_bar).all()),
        "chees funnel: non-finite")
    check(float((v < -2).float().mean()) > 0.08 and abs(float(v.mean())) < 1.2,
          "chees funnel: the neck")
    sync()


def phase_timing_slice4(models, label, errs, times):
    """The three kernels at the main paths' shapes (best of 3), the plain
    versions at 8192 chains over N_PLAIN_SLICE4 steps, held against them, and
    the ChEES stages timed apart."""
    from advancedmh_tpu_torch import MEADS, ChEESHMC, Schedule
    from advancedmh_tpu_torch import sample
    from advancedmh_tpu_torch.ops import (CheesParams, MeadsParams, chees_frozen_reference,
                                          chees_warmup_reference, fused_chees_frozen_sample,
                                          fused_chees_warmup_block, fused_meads_sample,
                                          meads_reference, vdc)
    from advancedmh_tpu_torch.runtime.fused import (MAX_TILE, MEADS_BUDGET, fused_tile,
                                                    sample_fused_chees)

    lr, C = models["logreg"], LOGREG_CHAINS
    spl = ChEESHMC(**CHEES)
    clock = {}
    sync()
    t0 = time.perf_counter()
    tr, st = sample_fused_chees(lr, spl, Schedule(N_DRAWS, num_warmup=N_WARM), key=KEY + 70,
                                num_chains=C, initial_params=torch.zeros(32, device=DEVICE),
                                stage_clock=clock)
    sync()
    t_all = time.perf_counter() - t0
    print(f"[{label}] chees stages at {C} x ({N_WARM} + {N_DRAWS}): warmup "
          f"{len(clock['attempts'])} launch(es) + tile combine "
          f"{clock['warmup_launch_s'] * 1e3:.4f} ms, the rest before the frozen launch (initial "
          f"lp and gradient, host staging of R) "
          f"{(clock['warmup_s'] - clock['warmup_launch_s']) * 1e3:.4f} ms, frozen launch "
          f"{clock['sampling_s'] * 1e3:.4f} ms, whole call {t_all * 1e3:.4f} ms; ratio "
          f"{clock['ratio']}, frozen trips {clock['trips']}")
    x, lp, g = (st.inner.params.T.contiguous(), st.inner.lp[None].contiguous(),
                st.inner.gradient.T.contiguous())
    vg = lr.tile_value_and_grad
    att = clock["attempts"][0]
    e_w = len(att["trips"])
    us = tuple(vdc(j + 1) for j in range(e_w))
    sv = torch.tensor([np.log(CHEES["initial_step_size"])] * 2 + [0.0] * 5 + [1.0, 0.0],
                      dtype=torch.float32, device=DEVICE)
    kw = dict(trips=att["trips"], us=us, n_groups=N_WARM // e_w, sv=sv,
              inverse_mass=torch.ones(32, 1, device=DEVICE), params=CheesParams.of(spl),
              tile_chains=att["tile"])
    x0 = torch.zeros(32, C, device=DEVICE)
    args = (vg, lr.cuda_density, x0, *vg(x0, *lr.tile_consts), lr.tile_consts, KEY)
    t_k, out = best_of(lambda: fused_chees_warmup_block(*args, **kw))
    del out
    short = dict(kw, n_groups=1)
    t_ks, out = best_of(lambda: fused_chees_warmup_block(*args, **short))
    t_p, ref = best_of(lambda: chees_warmup_reference(*args, **short), PLAIN_REPEATS)
    print(f"[{label}] chees_warmup logistic regression at {C} x {N_WARM} (tile {att['tile']}, "
          f"trips {att['trips']}): kernel {t_k * 1e3:.4f} ms; at {C} x {e_w}: kernel "
          f"{t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
    hold(errs, "chees_warmup", f"{C} x {e_w}", (out[0][None], out[1][None], out[3][None],
                                                 out[2]),
         (ref[0][None], ref[1][None], ref[3][None], ref[2]))
    times["chees_warmup"] = (t_k, t_p, bound_chees(C, att["trips"] * (N_WARM // e_w), 0, True),
                             f"plain at {C} x {e_w} steps")
    del out, ref

    eps = torch.exp(st.log_eps_bar[0:1]).reshape(1, 1)
    minv = st.inverse_mass[0].reshape(32, 1).contiguous()
    args = (vg, lr.cuda_density, x, lp, g, lr.tile_consts, KEY)
    kw = dict(trips=clock["trips"], phase=0, step_size=eps, inverse_mass=minv, thin=1,
              n_samples=N_DRAWS, iteration_offset=N_WARM)
    t_k, out = best_of(lambda: fused_chees_frozen_sample(*args, **kw))
    del out
    short = dict(kw, n_samples=N_PLAIN_SLICE4)
    t_ks, out = best_of(lambda: fused_chees_frozen_sample(*args, **short))
    t_p, ref = best_of(lambda: chees_frozen_reference(*args, **short), PLAIN_REPEATS)
    P = len(clock["trips"])
    n_trips = [clock["trips"][k % P] for k in range(N_DRAWS)]
    print(f"[{label}] chees_frozen logistic regression at {C} x {N_DRAWS} ({sum(n_trips)} "
          f"leapfrog steps a chain): kernel {t_k * 1e3:.4f} ms "
          f"({C * sum(n_trips) / t_k:.6e} chain-gradients/s); at {C} x {N_PLAIN_SLICE4}: "
          f"kernel {t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
    hold(errs, "chees_frozen", f"{C} x {N_PLAIN_SLICE4}", out[:3], ref[:3])
    times["chees_frozen"] = (t_k, t_p, bound_chees(C, n_trips, N_DRAWS, False),
                             f"plain at {C} x {N_PLAIN_SLICE4} steps")
    del out, ref

    tile = fused_tile(C, MAX_TILE, 32, MEADS_BUDGET)
    rng = np.random.default_rng(7)
    mom = torch.tensor(rng.normal(size=(32, C)), dtype=torch.float32, device=DEVICE)
    u = torch.tensor(rng.uniform(size=(1, C)), dtype=torch.float32, device=DEVICE)
    args = (vg, lr.cuda_density, x0, *vg(x0, *lr.tile_consts), mom, u, lr.tile_consts, KEY)
    kw = dict(n_folds=2, t0=1, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS,
              params=MeadsParams.of(MEADS(n_folds=2)), tile_chains=tile)
    t_k, out = best_of(lambda: fused_meads_sample(*args, **kw))
    acc = float(out[2].mean())
    del out
    short = dict(kw, burn=0, n_samples=N_PLAIN_SLICE4)
    t_ks, out = best_of(lambda: fused_meads_sample(*args, **short))
    t_p, ref = best_of(lambda: meads_reference(*args, **short), PLAIN_REPEATS)
    steps = N_WARM - 1 + N_DRAWS
    print(f"[{label}] meads logistic regression at {C} x ({N_WARM - 1} + {N_DRAWS}), K=2, tile "
          f"{tile}: kernel {t_k * 1e3:.4f} ms ({C * steps / t_k:.6e} chain-steps/s, acceptance "
          f"{acc:.4f}); at {C} x {N_PLAIN_SLICE4}: kernel {t_ks * 1e3:.4f} ms, plain "
          f"{t_p * 1e3:.4f} ms")
    hold(errs, "meads", f"{C} x {N_PLAIN_SLICE4}", out, ref)
    times["meads"] = (t_k, t_p, bound_meads(C, steps, N_DRAWS),
                      f"plain at {C} x {N_PLAIN_SLICE4} steps")
    del out, ref
    # the same launch on the correlated Gaussian (d = 2): the pooling and
    # barriers with a trivial density and Gram matrix
    m2 = models["corr"]
    x2 = torch.zeros(2, C, device=DEVICE)
    args = (m2.tile_value_and_grad, m2.cuda_density, x2, *m2.tile_value_and_grad(
        x2, *m2.tile_consts), mom[:2].contiguous(), u, m2.tile_consts, KEY)
    kw2 = dict(kw, tile_chains=fused_tile(C, MAX_TILE, 2, MEADS_BUDGET))
    t_2, out = best_of(lambda: fused_meads_sample(*args, **kw2))
    del out
    print(f"[{label}] meads correlated Gaussian d=2 at {C} x ({N_WARM - 1} + {N_DRAWS}), K=2, "
          f"tile {kw2['tile_chains']}: kernel {t_2 * 1e3:.4f} ms ({t_2 / steps * 1e6:.3f} us a "
          f"step; d = 32: {t_k / steps * 1e6:.3f} us)")

    names = [f"β{j}" for j in range(32)]
    for name, s, kw in (("chees", spl, dict(num_warmup=N_WARM)),
                        ("meads", MEADS(n_folds=2), {})):
        time_path(label, f"{name} sample(engine='fused') logistic regression {C} x "
                  f"({N_WARM} + {N_DRAWS})",
                  lambda: sample(lr, s, N_DRAWS, num_chains=C, engine="fused",
                                 discard_initial=N_WARM, initial_params=torch.zeros(32, device=DEVICE),
                                 key=KEY + 73, chain_type="chains", param_names=names, **kw), "β0")


# ---- slice 5: slice sampling, elliptical slice, Barker and pCN ----------------------------

# The main paths: the funnel slice row (bench.py:496-510), the GP classification
# of examples/ess_gp.py:26-31, the GP regression of tests/test_ess.py at d = 64,
# and Barker on the flagship (benchmarks/samplers.py:544-553) and on the logistic
# regression.
SLICE = dict(width=3.0, max_stepout=8, max_shrink=24)
GP_CHAINS = 8192
PCN_WARM = 2000
PCN_BETA = 0.2
BARKER_EPS = 0.05
N_PLAIN_SLICE5 = 10  # steps of the slice-5 plain versions timed at the main paths' widths


def gp_models():
    """The GP latent fields of slice 5, (model, prior, aux) each: regression
    (noise 0.3, seed 3) and classification (seed 5) at d = 16 and 64."""
    from advancedmh_tpu_torch.models import gp_latent_model

    return {f"{kind}{d}": gp_latent_model(d, **kw, device=DEVICE) for d in (16, 64)
            for kind, kw in (("reg", dict(noise=0.3, seed=3)),
                             ("class", dict(likelihood="logistic", seed=5)))}


def _prior_start(prior, C, seed):
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return prior.sample(gen, (C,)).T.contiguous()


def phase_kernels_slice5(models, gps, errs, evals):
    """The four slice-5 kernels against their plain versions at 64-step
    cases: slice on the funnel and the correlated Gaussian (2048 chains, one
    with burn > 0 and thin = 3), ESS and pCN on the GP regression and
    classification at d = 16 and 64 (1024 chains, the tril and the diagonal
    prior), Barker on the flagship (2048) and the logistic regression (1024).
    The plain versions of slice and ESS count the density evaluations a
    chain-step needs (``evals``)."""
    from advancedmh_tpu_torch.ops import (barker_sample_reference, ess_sample_reference,
                                          fused_barker_sample, fused_ess_sample,
                                          fused_pcn_sample, fused_slice_sample,
                                          pcn_sample_reference, slice_sample_reference)

    def report(name, tag, got, ref, visible):
        r = agreement(got[:3], ref[:3])
        print(f"kernel {name} {tag}: {r}")
        check_agreement(name, r, SHORT_RUN_CHAINS_MIN, visible_steps=visible)
        errs[name] = max(errs[name], r["max_abs_err"])

    for key, C, width, burn, thin, n in (("funnel", 2048, 3.0, 0, 1, 64),
                                         ("corr", 2048, 1.5, 4, 3, 20)):
        m = models[key]
        p = _gauss_start(m.dimension, C, 120)
        args = (m.tile_density, m.cuda_density, p, m.tile_density(p, *m.tile_consts),
                m.tile_consts, 0x51CE)
        kw = dict(width=width, max_stepout=8, max_shrink=24, burn=burn, thin=thin,
                  n_samples=n, iteration_offset=(1 << 32) - 30)
        st = {}
        got, ref = fused_slice_sample(*args, **kw), slice_sample_reference(*args, **kw, stats=st)
        evals[f"slice {key}"] = st["density_evals"] / (C * (burn + n * thin))
        report("slice", f"{key} C={C} width={width} burn={burn} thin={thin} n={n} "
               f"(density evaluations a chain-step: {evals[f'slice {key}']:.4f})", got, ref,
               burn == 0 and thin == 1)

    for name, (m, prior, _) in gps.items():
        C, d = 1024, m.dimension
        x = _prior_start(prior, C, 121)
        lp = m.tile_density(x, *m.tile_consts)
        for tril in (True, False):
            scale = prior.scale_tril if tril else torch.linspace(0.5, 1.5, d, device=DEVICE)
            args = (m.tile_density, m.cuda_density, x, lp, torch.zeros(d, device=DEVICE),
                    scale, m.tile_consts, 0xE550 + d)
            kw = dict(burn=0, thin=1, n_samples=64, iteration_offset=7)
            st = {}
            got = fused_ess_sample(*args, max_shrink=24, **kw)
            ref = ess_sample_reference(*args, max_shrink=24, **kw, stats=st)
            evals[f"ess {name} tril={tril}"] = st["density_evals"] / (C * 64)
            report("ess", f"{name} tril={tril} C={C} 64 steps (likelihood evaluations a "
                   f"chain-step: {evals[f'ess {name} tril={tril}']:.4f}; the largest of 4 "
                   f"chains {st['max_trips_4']:.4f}, of 32 {st['max_trips_32']:.4f})", got, ref,
                   True)
            report("pcn", f"{name} tril={tril} C={C} 64 steps",
                   fused_pcn_sample(*args, beta=PCN_BETA, **kw),
                   pcn_sample_reference(*args, beta=PCN_BETA, **kw), True)

    for key, C, eps in (("flagship", 2048, BARKER_EPS), ("logreg", 1024, 0.05)):
        m = models[key]
        args = hmc_args(m, _slice3_start(m, C, 122), 0xBA4C)
        kw = dict(step_size=eps, burn=0, thin=1, n_samples=64, iteration_offset=3)
        got, ref = fused_barker_sample(*args, **kw), barker_sample_reference(*args, **kw)
        report("barker", f"{m.cuda_density} C={C} eps={eps} 64 steps", got, ref, True)
        hold_gradient("barker", got[3], ref[3], got[0], ref[0], got[2], ref[2])
    sync()


def _means_mcse(chains, names):
    """Per parameter: mean and MCSE from its own bulk ESS."""
    from advancedmh_tpu_torch import ess_bulk

    out = {}
    for n in names:
        x = chains[n]
        out[n] = (float(x.mean()), float(torch.std(x, correction=0)) / float(ess_bulk(x)) ** 0.5)
    return out


def phase_main_slice5(models, gps, label, launches, ref_summary):
    """The slice-5 main paths through sample(engine="fused") + summary(),
    each with its launch counter read: slice on the funnel, ESS on the GP
    classification and regression at d = 64, pCN on the regression, Barker
    on the flagship and on the logistic regression. Returns the adapted
    Barker step size of the logistic regression."""
    from advancedmh_tpu_torch import (Barker, EllipticalSlice, PreconditionedCrankNicolson,
                                      SliceSampler, StepSizeAdaptation, ess_bulk, sample)

    def path(name, model, spl, n_warm, kernel, num_chains=GP_CHAINS, **kw):
        return _fused_path(name, model, spl, N_DRAWS, n_warm, kernel, launches, label,
                           num_chains, **kw)

    res, chains, summary, acc = path("slice funnel", models["funnel"], SliceSampler(**SLICE),
                                     N_WARM, "slice", key=KEY + 80,
                                     initial_params=torch.zeros(10, device=DEVICE))
    v = res.transitions.params[:, :, 0]
    p2, p4 = float((v < -2).float().mean()), float((v < -4).float().mean())
    print(f"slice funnel: P(v < -2) {p2:.4f} (exact 0.2525), P(v < -4) {p4:.4f} (exact 0.0912), "
          f"mean v {float(v.mean()):.4f}")
    check(acc >= 0.95, f"slice funnel acceptance {acc}")
    check(0.22 <= p2 <= 0.28, f"slice funnel P(v < -2) {p2}")
    check(abs(float(v.mean())) < 0.3, "slice funnel mean v")

    m, prior, aux = gps["class64"]
    res, chains, summary, acc = path("ess gp classification d=64", m, EllipticalSlice(prior),
                                     N_WARM, "ess", key=KEY + 81)
    post = res.transitions.params.mean((0, 1)).double().cpu().numpy()
    f_true = aux["f_true"]
    conf = np.abs(f_true) > 0.5
    agree = float((np.sign(post[conf]) == np.sign(f_true[conf])).mean())
    corr = float(np.corrcoef(post, f_true)[0, 1])
    print(f"ess gp classification: sign agreement on |f_true| > 0.5 {agree:.4f}, corr(posterior "
          f"mean, f_true) {corr:.4f} ({int((aux['y'] > 0).sum())} of 64 labels are +1)")
    check(agree >= 0.95, "ess gp classification sign agreement")
    check(acc > 0.995, f"ess gp classification acceptance {acc}")
    # The labels fix the sign of the posterior mean, not its shape (f_true is
    # negative on the whole grid at this seed), so the mean is held against an
    # engine="torch" ESS run of the same model instead of f_true's shape.
    ref = sample(m, EllipticalSlice(prior), 600, key=KEY + 82, num_chains=512,
                 discard_initial=N_WARM, chain_type="chains", param_names=kw_names(m))
    compare_means("ess gp classification", summary, ref.summary(), kw_names(m))

    m, prior, aux = gps["reg64"]
    res, chains, summary, acc = path("ess gp regression d=64", m, EllipticalSlice(prior), N_WARM,
                                     "ess", key=KEY + 83)
    d = res.transitions.params
    mean, var = d.mean((0, 1)).double().cpu().numpy(), d.var((0, 1)).double().cpu().numpy()
    m_err = float(np.abs(mean - aux["post_mean"]).max())
    v_err = float(np.max(np.abs(var - np.diag(aux["post_cov"]))
                         / (0.01 + 0.15 * np.diag(aux["post_cov"]))))
    print(f"ess gp regression: max |mean - closed form| {m_err:.5f} (atol 0.03), variance "
          f"error over its tolerance {v_err:.4f} (rtol 0.15, atol 0.01)")
    check(m_err < 0.03 and v_err < 1.0, "ess gp regression against the closed form")
    check(acc > 0.995, f"ess gp regression acceptance {acc}")

    res, chains, summary, acc = path("pcn gp regression d=64", m,
                                     PreconditionedCrankNicolson(prior, beta=PCN_BETA), PCN_WARM,
                                     "pcn", key=KEY + 84)
    mm = _means_mcse(chains, kw_names(m))
    worst = max(abs(mm[n][0] - aux["post_mean"][i]) / mm[n][1]
                for i, n in enumerate(kw_names(m)))
    print(f"pcn gp regression: acceptance {acc:.4f}; largest |mean - closed form| / MCSE "
          f"{worst:.3f} (limit 5)")
    check(worst < 5.0, "pcn gp regression means against the closed form")

    flag = models["flagship"]
    res, chains, summary, acc = path("barker flagship", flag, Barker(BARKER_EPS), N_WARM,
                                     "barker", num_chains=N_CHAINS, key=KEY + 85,
                                     initial_params=[0.0, 1.0])
    mu_q, sig_q = grid_posterior_means(flag.tile_consts[0].cpu().numpy().ravel())
    # At ε = 0.05 a chain of 4000 draws holds ~50 effective draws, so R̂ of a
    # stationary run sits near sqrt(1 + 1/50) ≈ 1.01: held at 1.05, as the
    # logistic regression's path.
    rhat = max(s["rhat"] for s in summary.values())
    per_chain = float(ess_bulk(chains["μ"])) / N_CHAINS
    print(f"barker flagship: means {summary['μ']['mean']:.5f}, {summary['σ']['mean']:.5f} "
          f"(quadrature {mu_q:.5f}, {sig_q:.5f}); max R-hat {rhat:.5f} with "
          f"{per_chain:.1f} effective draws a chain")
    check(abs(summary["μ"]["mean"] - mu_q) < 0.01 and abs(summary["σ"]["mean"] - sig_q) < 0.01,
          "barker flagship: means vs quadrature")
    check(rhat < 1.05, f"barker flagship: R-hat {rhat}")

    lr = models["logreg"]
    t0 = time.perf_counter()
    warm = sample(lr, StepSizeAdaptation.barker(), 1, num_chains=512, num_warmup=N_WARM,
                  discard_initial=N_WARM, initial_params=torch.zeros(32, device=DEVICE),
                  key=KEY + 86)
    eps = float(torch.exp(warm.final_state.log_eps_bar).median())
    print(f"[{label}] engine=torch StepSizeAdaptation.barker() warmup 512 x {N_WARM}: "
          f"{time.perf_counter() - t0:.4f} s, median eps-bar {eps:.6f}")
    res, chains, summary, acc = path("barker logistic regression", lr, Barker(eps), N_WARM,
                                     "barker", key=KEY + 87,
                                     initial_params=torch.zeros(32, device=DEVICE))
    rhat = max(s["rhat"] for s in summary.values())
    check(rhat < 1.05, f"barker logistic regression: R-hat {rhat}")
    compare_means("barker logistic regression", summary, ref_summary, kw_names(lr))
    return eps


def kw_names(model):
    """The parameter names the paths bundle under."""
    if model.cuda_density == "gaussian_mean_scale":
        return ["μ", "σ"]
    if model.cuda_density == "logistic_regression":
        return [f"β{j}" for j in range(32)]
    if model.cuda_density == "neal_funnel":
        return ["v"] + [f"x{i}" for i in range(1, 10)]
    if model.cuda_density in ("correlated_gaussian", "banana"):
        return [f"x{i}" for i in range(model.dimension)]
    return [f"f{i}" for i in range(model.dimension)]


def phase_slice5_checks(models, gps):
    """tests/test_pallas.py's card-only checks of the four samplers at their
    shapes (the diagonal prior in place of ESS's scalar custom density) and
    split runs of all four through initial_state + iteration_offset, held
    bit for bit."""
    from advancedmh_tpu_torch import (Barker, EllipticalSlice, MvNormal,
                                      PreconditionedCrankNicolson, SliceSampler, sample)

    sig = np.array([[1.5, 0.35], [0.35, 1.0]])
    corr, flag = models["corr"], models["flagship"]

    def flat(res, d):
        return res.transitions.params.reshape(-1, d).double().cpu().numpy()

    res = sample(corr, Barker(step_size=0.9), 4000, key=13, num_chains=N_CHECK, engine="fused",
                 discard_initial=1000, initial_params=[1.0, 1.0])
    dr, acc = flat(res, 2), float(res.transitions.accepted.float().mean())
    x = res.final_state.params.double().cpu().numpy()
    g_err = np.abs(res.final_state.gradient.double().cpu().numpy()
                   + (np.linalg.inv(sig) @ x.T).T).max()
    print(f"barker correlated {N_CHECK}x(1000+4000): acceptance {acc:.4f} mean "
          f"{dr.mean(0).tolist()} cov {np.cov(dr.T).tolist()} final-gradient |err| {g_err:.3g}")
    check(np.allclose(dr.mean(0), 0.0, atol=0.05), "barker correlated mean")
    check(np.allclose(np.cov(dr.T), sig, atol=0.1), "barker correlated covariance")
    check(0.3 < acc < 0.9, "barker correlated acceptance")
    check(g_err < 1e-3 * (1 + np.abs(x).max()), "barker correlated final gradient")

    m, prior, aux = gps["reg16"]
    spl = PreconditionedCrankNicolson(prior, beta=0.2)
    res = sample(m, spl, 4000, key=11, num_chains=N_CHECK, engine="fused", discard_initial=2000)
    p = res.transitions.params
    mean, var = p.mean((0, 1)).double().cpu().numpy(), p.var((0, 1)).double().cpu().numpy()
    acc = float(res.transitions.accepted.float().mean())
    res_t = sample(m, spl, 500, key=12, num_chains=1024, engine="fused", discard_initial=1000,
                   thinning=4)
    mean_t = res_t.transitions.params.mean((0, 1)).double().cpu().numpy()
    print(f"pcn gp d=16 {N_CHECK}x(2000+4000): acceptance {acc:.4f}, max |mean - closed form| "
          f"{np.abs(mean - aux['post_mean']).max():.5f}; thin 4: "
          f"{np.abs(mean_t - aux['post_mean']).max():.5f}")
    check(np.allclose(mean, aux["post_mean"], atol=0.03), "pcn gp mean")
    check(np.allclose(var, np.diag(aux["post_cov"]), rtol=0.2, atol=0.01), "pcn gp variance")
    check(0.2 < acc < 0.95, "pcn gp acceptance")
    check(np.allclose(mean_t, aux["post_mean"], atol=0.05), "pcn gp thin 4 mean")

    res = sample(m, EllipticalSlice(prior), 800, key=11, num_chains=N_CHECK, engine="fused",
                 discard_initial=100)
    dr, acc = flat(res, 16), float(res.transitions.accepted.float().mean())
    print(f"ess gp d=16 {N_CHECK}x(100+800): acceptance {acc:.5f}, max |mean - closed form| "
          f"{np.abs(dr.mean(0) - aux['post_mean']).max():.5f}")
    check(np.allclose(dr.mean(0), aux["post_mean"], atol=0.03), "ess gp mean")
    check(np.allclose(dr.var(0), np.diag(aux["post_cov"]), rtol=0.15, atol=0.01),
          "ess gp variance")
    check(acc > 0.995, "ess gp acceptance")
    s2 = 0.3 ** 2
    diag = EllipticalSlice(MvNormal(torch.zeros(16, device=DEVICE),
                                    scale_diag=torch.ones(16, device=DEVICE)))
    res = sample(m, diag, 1000, key=3, num_chains=N_CHECK, engine="fused", discard_initial=600)
    dr = flat(res, 16)
    m_err = np.abs(dr.mean(0) - aux["y"] / (1.0 + s2)).max()
    v_err = np.abs(dr.var(0) / (s2 / (1.0 + s2)) - 1.0).max()
    print(f"ess diagonal prior d=16 {N_CHECK}x(600+1000): max |mean - y/(1+s2)| {m_err:.5f}, max "
          f"relative variance error {v_err:.4f}")
    check(m_err < 0.01 and v_err < 0.05, "ess diagonal prior closed form")
    mc, prior_c, aux_c = gps["class16"]
    res = sample(mc, EllipticalSlice(prior_c), 200, key=12, num_chains=1024, engine="fused",
                 discard_initial=100, thinning=3)
    conf = np.abs(aux_c["f_true"]) > 0.5
    agree = (np.sign(flat(res, 16).mean(0)[conf]) == np.sign(aux_c["f_true"][conf])).mean()
    print(f"ess gp logistic d=16 thin 3: sign agreement {agree:.4f}")
    check(agree > 0.95 and tuple(res.final_state.params.shape) == (1024, 16),
          "ess gp logistic thin 3")

    res = sample(flag, SliceSampler(width=0.5), 2000, key=14, num_chains=N_CHECK, engine="fused",
                 discard_initial=200, initial_params=[0.0, 1.0])
    dr, acc = flat(res, 2), float(res.transitions.accepted.float().mean())
    print(f"slice flagship {N_CHECK}x(200+2000): means {dr.mean(0).tolist()} (quadrature "
          f"0.0268, 1.1810), acceptance {acc:.5f}")
    check(abs(dr[:, 0].mean() - 0.0268) < 0.03 and abs(dr[:, 1].mean() - 1.1810) < 0.03,
          "slice flagship means")
    check(acc > 0.995, "slice flagship acceptance")
    res = sample(corr, SliceSampler(width=1.5), 1500, key=15, num_chains=N_CHECK, engine="fused",
                 discard_initial=300, thinning=2, initial_params=[0.0, 0.0])
    dr = flat(res, 2)
    print(f"slice correlated thin 2: mean {dr.mean(0).tolist()} cov {np.cov(dr.T).tolist()}")
    check(np.allclose(dr.mean(0), 0.0, atol=0.05) and np.allclose(np.cov(dr.T), sig, atol=0.1),
          "slice correlated thin 2")

    # split runs: 2n in one call = n, then n resumed from the final state
    split = [
        ("slice", flag, SliceSampler(width=0.5), dict(initial_params=[0.0, 1.0])),
        ("ess", mc, EllipticalSlice(prior_c), {}),
        ("barker", flag, Barker(BARKER_EPS), dict(initial_params=[0.0, 1.0])),
        ("pcn", m, PreconditionedCrankNicolson(prior, beta=0.2), {}),
    ]
    for name, mod, spl, init in split:
        kw = dict(num_chains=N_CHECK, engine="fused", key=KEY + 90, thinning=2)
        whole = sample(mod, spl, 400, discard_initial=N_WARM, **init, **kw)
        first = sample(mod, spl, 200, discard_initial=N_WARM, **init, **kw)
        rest = sample(mod, spl, 200, discard_initial=2, initial_state=first.final_state,
                      iteration_offset=N_WARM - 2 + 400, **kw)
        same = all(torch.equal(torch.cat([getattr(first.transitions, f),
                                          getattr(rest.transitions, f)], 1),
                               getattr(whole.transitions, f))
                   for f in ("params", "lp", "accepted"))
        if name == "barker":
            same = same and torch.equal(rest.final_state.gradient, whole.final_state.gradient)
        print(f"{name} split run {N_CHECK} chains, {N_WARM} + 2 x 200 thin 2: bit-exact {same}")
        check(same, f"{name}: the split run differs from the unsplit one")
    sync()


# float32 operations counted from csrc/{slice,ess,barker,pcn}.cu and the
# functors, as the earlier bounds (Philox's integer work not counted). A GP
# regression evaluation is 3d + 3, a classification 10d + 1 (negate-multiply,
# softplus's max, abs, exp, add, log and add, the sum), the funnel's 2d + 10
# (_FUNNEL_OPS) and a candidate x + t u (slice) 2d, (mu + (x - mu) cos) + nu sin
# (ESS) 5d and two of cosf/sinf.


def _gp_ops(d: int, regression: bool) -> int:
    return 3 * d + 3 if regression else 10 * d + 1


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _io_bytes(C: int, d: int, emitted: int, extra: int = 0) -> int:
    """x and lp in, the draws (d + 2 floats a chain and draw) out."""
    return ((d + 1) * C + emitted * (d + 2) * C + extra) * 4


def bound_slice(C: int, steps: int, emitted: int, evals: float, d: int = 10):
    """A slice launch on the funnel: per step the direction (noise, 3d and
    a sqrt, divide), the slice height and bracket (8), and ``evals``
    evaluations of a candidate (2d) and the funnel (2d + 10) plus the
    bracket update (4)."""
    step = _noise_ops(d) + 3 * d + 2 + 8 + evals * (4 * d + 14)
    return _bound(_io_bytes(C, d, emitted), step * steps * C)


def bound_ess(C: int, steps: int, emitted: int, evals: float, d: int, regression: bool,
              tril: bool = True):
    """An ESS launch on the GP: per step the noise, ν − μ (d(d+1) for the
    factor, d for a diagonal), the slice height and θ₀ (4), and ``evals``
    trips of a candidate (5d + 2), the likelihood and the bracket (5)."""
    step = (_noise_ops(d) + (d * (d + 1) if tril else d) + 4
            + evals * (5 * d + 2 + _gp_ops(d, regression) + 5))
    consts = d + (2 if regression else 0) + d + (d * d if tril else d)
    return _bound(_io_bytes(C, d, emitted, consts), step * steps * C)


def bound_pcn(C: int, steps: int, emitted: int, d: int, regression: bool):
    """A pCN launch on the GP: RWMH's step with L z (d(d+1)), the
    contraction (5d) and the accept (2)."""
    step = _noise_ops(d) + d * (d + 1) + 5 * d + _gp_ops(d, regression) + 2
    consts = d + (2 if regression else 0) + d + d * d
    return _bound(_io_bytes(C, d, emitted, consts), step * steps * C)


def bound_barker(C: int, steps: int, emitted: int, d: int, vg_ops: int, n_consts: int):
    """A Barker launch: per step the noise and σ z (d), the logit sign test
    (6d), δ and y (2d), one value and gradient, the Hastings sum (two
    softplus and four more a coordinate, 18d) and the accept (4). In: x,
    lp, the gradient and the constants; out: the draws and the gradient."""
    step = _noise_ops(d) + d + 6 * d + 2 * d + vg_ops + 18 * d + 4
    return _bound(_io_bytes(C, d, emitted, n_consts + 2 * d * C), step * steps * C)


def phase_timing_slice5(models, gps, label, errs, times, evals, barker_eps):
    """The four kernels at their main paths' shapes (best of 3) with their
    bounds, the plain versions at the paths' widths over N_PLAIN_SLICE5
    steps, held against the kernel there, and ESS/s of each path including
    summary()."""
    from advancedmh_tpu_torch import (Barker, EllipticalSlice, PreconditionedCrankNicolson,
                                      SliceSampler, sample)
    from advancedmh_tpu_torch.ops import (barker_sample_reference, ess_sample_reference,
                                          fused_barker_sample, fused_ess_sample,
                                          fused_pcn_sample, fused_slice_sample,
                                          pcn_sample_reference, slice_sample_reference)

    C, steps = GP_CHAINS, N_WARM - 1 + N_DRAWS
    short = dict(burn=0, n_samples=N_PLAIN_SLICE5)

    def timed(name, fn, plain, args, kw, tag):
        t_k, out = best_of(lambda: fn(*args, **kw))
        del out
        kws = dict(kw, **short)
        t_ks, out = best_of(lambda: fn(*args, **kws))
        t_p, ref = best_of(lambda: plain(*args, **kws), PLAIN_REPEATS)
        print(f"[{label}] {name} {tag}: kernel {t_k * 1e3:.4f} ms; at {args[2].shape[1]} x "
              f"{N_PLAIN_SLICE5}: kernel {t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
        hold(errs, name, f"{args[2].shape[1]} x {N_PLAIN_SLICE5}", out[:3], ref[:3])
        return t_k, t_p

    fun = models["funnel"]
    x0 = torch.zeros(10, C, device=DEVICE)
    args = (fun.tile_density, fun.cuda_density, x0, fun.tile_density(x0), (), KEY)
    kw = dict(**SLICE, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_k, t_p = timed("slice", fused_slice_sample, slice_sample_reference, args, kw,
                     f"funnel at {C} x ({N_WARM - 1} + {N_DRAWS})")
    ev = evals["slice funnel"]
    times["slice"] = (t_k, t_p, bound_slice(C, steps, N_DRAWS, ev),
                      f"plain at {C} x {N_PLAIN_SLICE5} steps; bound at {ev:.4f} evaluations a "
                      "chain-step (the 64-step case's)")
    print(f"[{label}] slice bound {times['slice'][2][0] * 1e3:.4f} ms ({times['slice'][2][1]})")

    for key, regression in (("class64", False), ("reg64", True)):
        m, prior, _ = gps[key]
        x = _prior_start(prior, C, 123)
        args = (m.tile_density, m.cuda_density, x, m.tile_density(x, *m.tile_consts),
                torch.zeros(64, device=DEVICE), prior.scale_tril, m.tile_consts, KEY)
        kw = dict(max_shrink=24, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
        t_k, t_p = timed("ess", fused_ess_sample, ess_sample_reference, args, kw,
                         f"gp {key} at {C} x ({N_WARM - 1} + {N_DRAWS})")
        ev = evals[f"ess {key} tril=True"]
        b = bound_ess(C, steps, N_DRAWS, ev, 64, regression)
        print(f"[{label}] ess {key} bound {b[0] * 1e3:.4f} ms ({b[1]}, {ev:.4f} evaluations a "
              f"chain-step)")
        if key == "class64":
            times["ess"] = (t_k, t_p, b, f"plain at {C} x {N_PLAIN_SLICE5} steps; bound at "
                            f"{ev:.4f} likelihood evaluations a chain-step (the 64-step case's)")

    m, prior, _ = gps["reg64"]
    x = _prior_start(prior, C, 124)
    args = (m.tile_density, m.cuda_density, x, m.tile_density(x, *m.tile_consts),
            torch.zeros(64, device=DEVICE), prior.scale_tril, m.tile_consts, KEY)
    kw = dict(beta=PCN_BETA, burn=PCN_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_k, t_p = timed("pcn", fused_pcn_sample, pcn_sample_reference, args, kw,
                     f"gp reg64 at {C} x ({PCN_WARM - 1} + {N_DRAWS})")
    times["pcn"] = (t_k, t_p, bound_pcn(C, PCN_WARM - 1 + N_DRAWS, N_DRAWS, 64, True),
                    f"plain at {C} x {N_PLAIN_SLICE5} steps")

    for key, Cb, eps in (("flagship", N_CHAINS, BARKER_EPS), ("logreg", C, barker_eps)):
        m = models[key]
        p0 = (torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, Cb).contiguous()
              if key == "flagship" else torch.zeros(32, Cb, device=DEVICE))
        args = hmc_args(m, p0, KEY)
        kw = dict(step_size=eps, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
        t_k, t_p = timed("barker", fused_barker_sample, barker_sample_reference, args, kw,
                         f"{key} at {Cb} x ({N_WARM - 1} + {N_DRAWS})")
        if key == "flagship":
            b = bound_barker(Cb, steps, N_DRAWS, 2, 8 * _N_OBS + 15, _N_OBS)
            times["barker"] = (t_k, t_p, b, f"plain at {Cb} x {N_PLAIN_SLICE5} steps")
        else:
            b = bound_barker(Cb, steps, N_DRAWS, 32, logreg_vg_ops(32, 256), 256 * 33 + 1)
        print(f"[{label}] barker {key} bound {b[0] * 1e3:.4f} ms ({b[1]})")

    zeros10 = torch.zeros(10, device=DEVICE)
    paths = [
        ("slice funnel", models["funnel"], SliceSampler(**SLICE), N_WARM, "v",
         dict(initial_params=zeros10)),
        ("ess gp classification d=64", gps["class64"][0], EllipticalSlice(gps["class64"][1]),
         N_WARM, "f0", {}),
        ("ess gp regression d=64", gps["reg64"][0], EllipticalSlice(gps["reg64"][1]), N_WARM,
         "f0", {}),
        ("pcn gp regression d=64", gps["reg64"][0],
         PreconditionedCrankNicolson(gps["reg64"][1], beta=PCN_BETA), PCN_WARM, "f0", {}),
        ("barker logistic regression", models["logreg"], Barker(barker_eps), N_WARM, "β0",
         dict(initial_params=torch.zeros(32, device=DEVICE))),
    ]
    for name, m, spl, n_warm, param, kw in paths:
        time_path(label, f"{name} sample(engine='fused') {C} x ({n_warm} + {N_DRAWS})",
                  lambda: sample(m, spl, N_DRAWS, num_chains=C, engine="fused",
                                 discard_initial=n_warm, key=KEY + 91, chain_type="chains",
                                 param_names=kw_names(m), **kw), param)
    time_path(label, f"barker flagship sample(engine='fused') {N_CHAINS} x ({N_WARM} + "
              f"{N_DRAWS})",
              lambda: sample(models["flagship"], Barker(BARKER_EPS), N_DRAWS,
                             num_chains=N_CHAINS, engine="fused", discard_initial=N_WARM,
                             initial_params=[0.0, 1.0], key=KEY + 92, chain_type="chains",
                             param_names=["μ", "σ"]), "μ")


# ---- slice 6: Adaptive Metropolis, delayed rejection and DRAM ---------------------------

# The main paths: AM on the correlated Gaussian of benchmarks/samplers.py:567-595
# and DRAM on that of :314-339, both 16384 x (2000 + 2000) from zeros, and DR on
# the flagship with stage scales 0.5 and 0.1 (:272-292) at 16384 x (500 + 4000).
AM_WARM = 2000
AM_DRAWS = 2000
DR_SCALES = (0.5, 0.1)
N_PLAIN_SLICE6 = 10  # steps of the slice-6 plain versions timed at the main paths' widths


def _am_block(m, C, seed, resumed=False):
    """The AM and DRAM kernels' inputs at C chains: x ~ N(0, 1) (the banana's
    x1 ~ N(0, 100)), its lp, and fresh moments (mean x, L = (0.1/√d) I, n = 1)
    or resumed ones (mean ~ N(0, 0.1²), a random lower factor with its
    diagonal in [0.5, 1.5], n = 5000)."""
    d = m.dimension
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, C))
    if m.cuda_density == "banana":
        x[0] *= 10.0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=DEVICE).contiguous()
    if resumed:
        L = np.tril(rng.normal(0.0, 0.3, (C, d, d)), -1)
        L[:, np.arange(d), np.arange(d)] = rng.uniform(0.5, 1.5, (C, d))
        mean, L, n = rng.normal(0.0, 0.1, (d, C)), L.reshape(C, d * d).T, np.full((1, C), 5000.0)
    else:
        L = np.broadcast_to((np.float32(0.1 / np.sqrt(d)) * np.eye(d)).reshape(d * d, 1),
                            (d * d, C))
        mean, n = x, np.ones((1, C))
    x = f32(x)
    return x, m.tile_density(x, *m.tile_consts), f32(mean), f32(L), f32(n)


def phase_kernels_slice6(models, errs):
    """The three slice-6 kernels against their plain versions at 64-step
    cases, 2048 chains: AM and DRAM on the correlated Gaussian at d = 2, 4, 8
    and the banana (fresh starts whose adapt_start falls inside the run, a
    resumed (mean, L, n) at n = 5000, one case with burn > 0 and thin = 3),
    states, lp, decisions and the final (mean, L, n) compared; DR on the
    flagship at 30 observations (starts outside the support among them) and
    300, and on the banana."""
    from advancedmh_tpu_torch.ops import (AmParams, DramParams, am_sample_reference,
                                          dr_sample_reference, dram_sample_reference,
                                          fused_am_sample, fused_dr_sample, fused_dram_sample)

    def report(name, tag, got, ref, visible):
        r = agreement(got, ref)
        print(f"kernel {name} {tag}: {r}")
        check_agreement(name, r, SHORT_RUN_CHAINS_MIN, visible_steps=visible)
        errs[name] = max(errs[name], r["max_abs_err"])

    C = 2048
    cases = [  # (model, burn, thin, n, offset, resumed, adapt_start)
        ("corr_ram", 0, 1, 64, 0, False, None),
        ("corr4", 0, 1, 64, (1 << 32) - 30, False, 40),
        ("corr8", 5, 3, 19, 7, False, None),
        ("banana", 0, 1, 64, 11, False, None),
        ("corr8", 0, 1, 64, 3, True, None),
        ("banana", 4, 1, 60, 0, True, None),
    ]
    for i, (key, burn, thin, n, off, resumed, start) in enumerate(cases):
        m = models[key]
        block = _am_block(m, C, 130 + i, resumed)
        args = (m.tile_density, m.cuda_density, *block, m.tile_consts, 0xA3A0 + i)
        kw = dict(burn=burn, thin=thin, n_samples=n, iteration_offset=off)
        tag = (f"{m.cuda_density} d={m.dimension} C={C} burn={burn} thin={thin} n={n} "
               f"offset={off} {'resumed n=5000' if resumed else 'fresh'}")
        am = dict(params=AmParams(adapt_start=start))
        report("am", f"{tag} adapt_start={start}", fused_am_sample(*args, **kw, **am),
               am_sample_reference(*args, **kw, **am), burn == 0 and thin == 1)
        dram = dict(params=DramParams())
        report("dram", tag, fused_dram_sample(*args, **kw, **dram),
               dram_sample_reference(*args, **kw, **dram), burn == 0 and thin == 1)

    dr_cases = [  # (model, scale1, scale2, burn, thin, n, offset)
        ("flagship", 0.5, 0.1, 0, 1, 64, 0),
        ("flag300", 8.0, 0.15, 3, 3, 20, (1 << 32) - 20),
        ("banana", [3.0, 1.0], [0.6, 0.2], 0, 1, 64, 5),
    ]
    for i, (key, s1, s2, burn, thin, n, off) in enumerate(dr_cases):
        m = models[key]
        p = (_start(C, 140 + i) if m.cuda_density == "gaussian_mean_scale"
             else _am_block(m, C, 140 + i)[0])
        args = (m.tile_density, m.cuda_density, p, m.tile_density(p, *m.tile_consts),
                torch.tensor(s1, device=DEVICE), torch.tensor(s2, device=DEVICE),
                m.tile_consts, 0xD400 + i)
        kw = dict(burn=burn, thin=thin, n_samples=n, iteration_offset=off)
        report("dr", f"{key} C={C} scales {s1}, {s2} burn={burn} thin={thin} n={n} "
               f"offset={off}", fused_dr_sample(*args, **kw), dr_sample_reference(*args, **kw),
               burn == 0 and thin == 1)
    sync()


def _fused_path(name, model, spl, n_draws, n_warm, kernel, launches, label, num_chains, **kw):
    """One main path: sample(engine="fused") + summary() with every launch
    counter set to 0 just before it and read just after; returns the result,
    its Chains, their summary and the acceptance."""
    from advancedmh_tpu_torch import ess_bulk, sample

    names = kw_names(model)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    res = sample(model, spl, n_draws, num_chains=num_chains, engine="fused",
                 discard_initial=n_warm, **kw)
    chains = res.to_chains(param_names=names)
    summary = chains.summary()
    sync()
    t = time.perf_counter() - t0
    got = read_launches()
    check_launches(f"{name} main path", got, {kernel: 1})
    launches[kernel] = launches.get(kernel, 0) + got[kernel]
    check(bool(torch.isfinite(res.transitions.lp).all()), f"{name}: non-finite lp")
    check(bool(torch.isfinite(chains.values).all()), f"{name}: non-finite draws")
    acc = float(res.transitions.accepted.float().mean())
    ess0 = float(ess_bulk(chains[names[0]]))
    print(f"[{label}] {name} first sample(engine='fused') + summary {t:.4f} s; acceptance "
          f"{acc:.4f}; max R-hat {max(s['rhat'] for s in summary.values()):.5f}; "
          f"ess_bulk({names[0]})={ess0:.1f}, ESS/s({names[0]}) incl. summary {ess0 / t:.6e}")
    return res, chains, summary, acc


def _learned_corr(L):
    """The correlation of the chain mean of L Lᵀ over final states (C, d, d)."""
    LL = torch.einsum("cij,ckj->cik", L.double(), L.double()).mean(0).cpu().numpy()
    return LL[0, 1] / np.sqrt(LL[0, 0] * LL[1, 1])


def _cov_ok(draws, sig, rtol=0.1, atol=0.05):
    return np.allclose(np.cov(draws.T), np.asarray(sig), rtol=rtol, atol=atol)


def phase_main_slice6(models, label, launches):
    """AM on Σ = [[1, .5], [.5, 1]] and DRAM on Σ = [[1.5, .35], [.35, 1]] at
    16384 x (2000 + 2000) from zeros, DR on the flagship (scales 0.5, 0.1) at
    16384 x (500 + 4000) from (0, 1), each through sample(engine="fused") +
    summary() with its launch counter read."""
    from advancedmh_tpu_torch import (DRAM, AdaptiveMetropolis, DelayedRejection, MvNormal,
                                      RandomWalkProposal)

    def path(name, model, spl, n_draws, n_warm, kernel, **kw):
        res, _, summary, acc = _fused_path(name, model, spl, n_draws, n_warm, kernel, launches,
                                           label, N_CHAINS, **kw)
        rhat = max(s["rhat"] for s in summary.values())
        check(rhat < 1.01, f"{name}: R-hat {rhat}")
        return res, summary, acc

    zeros = torch.zeros(2, device=DEVICE)
    res, summary, acc = path("am correlated", models["corr_ram"], AdaptiveMetropolis(), AM_DRAWS,
                             AM_WARM, "am", key=KEY + 100, initial_params=zeros)
    draws = res.transitions.params.reshape(-1, 2).double().cpu().numpy()
    corr = _learned_corr(res.final_state.L)
    it = res.final_state.iteration
    print(f"am correlated: cov {np.cov(draws.T).tolist()}, corr of mean L L' {corr:.4f}, "
          f"final iteration {int(it.min())}..{int(it.max())}")
    check(_cov_ok(draws, [[1.0, 0.5], [0.5, 1.0]]), "am correlated covariance")
    check(abs(corr - 0.5) < 0.1, f"am correlated: learned correlation {corr}")
    check(bool((it == 1 + (AM_WARM - 1) + AM_DRAWS).all()), "am: final iteration count")

    res, summary, acc = path("dram correlated", models["corr"], DRAM(), AM_DRAWS, AM_WARM, "dram",
                             key=KEY + 101, initial_params=zeros)
    draws = res.transitions.params.reshape(-1, 2).double().cpu().numpy()
    print(f"dram correlated: cov {np.cov(draws.T).tolist()}")
    check(_cov_ok(draws, [[1.5, 0.35], [0.35, 1.0]]), "dram correlated covariance")
    check(0.2 < acc < 0.9, f"dram correlated acceptance {acc}")

    flag = models["flagship"]
    rw = lambda s: RandomWalkProposal(MvNormal(zeros, scale=s), symmetric=True)
    res, summary, acc = path("dr flagship", flag,
                             DelayedRejection(rw(DR_SCALES[0]), rw(DR_SCALES[1])), N_DRAWS,
                             N_WARM, "dr", key=KEY + 102, initial_params=[0.0, 1.0])
    mu_q, sig_q = grid_posterior_means(flag.tile_consts[0].cpu().numpy().ravel())
    print(f"dr flagship: means {summary['μ']['mean']:.5f}, {summary['σ']['mean']:.5f} "
          f"(quadrature {mu_q:.5f}, {sig_q:.5f})")
    posterior_check("dr flagship", summary, mu_q, sig_q)


def phase_slice6_checks(models):
    """tests/test_pallas.py's card-only AM, DRAM and DR checks at their
    shapes, the AM split across two calls (count 6000), DRAM on the banana
    (tests/test_geometry.py), split runs of all three bit for bit, and the
    errors for pooled AM/DRAM, a full-covariance DR stage and d > 8."""
    from advancedmh_tpu_torch import (DRAM, AdaptiveMetropolis, DelayedRejection, MvNormal,
                                      RandomWalkProposal, sample)
    from advancedmh_tpu_torch.models import correlated_gaussian_model

    sig = [[1.0, 0.5], [0.5, 1.0]]
    corr, zeros = models["corr_ram"], torch.zeros(2, device=DEVICE)

    def flat(res):
        return res.transitions.params.reshape(-1, 2).double().cpu().numpy()

    for spl in (AdaptiveMetropolis(), DRAM()):
        name = type(spl).__name__
        res = sample(corr, spl, 4000, key=9, num_chains=N_CHECK, engine="fused",
                     discard_initial=4000, initial_params=zeros)
        dr, lc = flat(res), _learned_corr(res.final_state.L)
        acc = float(res.transitions.accepted.float().mean())
        n_final = res.final_state.iteration
        print(f"{name} correlated {N_CHECK}x(4000+4000): cov {np.cov(dr.T).tolist()}, learned "
              f"corr {lc:.4f}, acceptance {acc:.4f}, final count {int(n_final[0])}")
        check(_cov_ok(dr, sig), f"{name} correlated covariance")
        check(abs(lc - 0.5) < 0.1, f"{name} learned correlation")
        check(bool((n_final == 1 + 3999 + 4000).all()), f"{name} final count")
        if isinstance(spl, DRAM):
            check(0.2 < acc < 0.9, "DRAM correlated acceptance")

    # AM across two calls: 2000 + 2000 draws after 1999 burn-in steps
    kw = dict(key=9, num_chains=N_CHECK, engine="fused")
    whole = sample(corr, AdaptiveMetropolis(), 4000, discard_initial=2000, initial_params=zeros,
                   **kw)
    first = sample(corr, AdaptiveMetropolis(), 2000, discard_initial=2000, initial_params=zeros,
                   **kw)
    rest = sample(corr, AdaptiveMetropolis(), 2000, discard_initial=1,
                  initial_state=first.final_state, iteration_offset=1999 + 2000, **kw)
    same = all(torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], 1),
                           getattr(whole.transitions, f)) for f in ("params", "lp", "accepted"))
    same = same and all(torch.equal(getattr(rest.final_state, f), getattr(whole.final_state, f))
                        for f in ("mean", "L", "iteration"))
    n_final = rest.final_state.iteration
    print(f"AM resumed across a split {N_CHECK}x(2000 + 2 x 2000): bit-exact {same}, final "
          f"count {int(n_final[0])}, cov {np.cov(flat(whole).T).tolist()}")
    check(same, "AM: the split run differs from the unsplit one")
    check(bool((n_final == 6000).all()), "AM: final count across the split")
    check(_cov_ok(flat(whole), sig, rtol=0.15), "AM split covariance")

    flag300 = models["flag300"]
    rw = lambda s: RandomWalkProposal(MvNormal(zeros, scale=s), symmetric=True)
    spl = DelayedRejection(rw(8.0), rw(0.15))
    res = sample(flag300, spl, 1500, key=0, num_chains=N_CHECK, engine="fused",
                 initial_params=[0.0, 1.0], discard_initial=500)
    dr, acc = flat(res), float(res.transitions.accepted.float().mean())
    res_t = sample(flag300, spl, 300, key=1, num_chains=1024, engine="fused",
                   initial_params=[0.0, 1.0], discard_initial=300, thinning=3)
    dr_t = flat(res_t)
    print(f"DR flagship 300 obs scales 8, 0.15 {N_CHECK}x(500+1500): means {dr.mean(0).tolist()}, "
          f"acceptance {acc:.4f}; thin 3: means {dr_t.mean(0).tolist()}")
    check(abs(dr[:, 0].mean()) < 0.1 and abs(dr[:, 1].mean() - 1.0) < 0.1, "DR means")
    check(acc > 0.1, f"DR acceptance {acc}")
    check(abs(dr_t[:, 0].mean()) < 0.12 and abs(dr_t[:, 1].mean() - 1.0) < 0.12, "DR thin 3")

    res = sample(models["banana"], DRAM(), 4000, key=0, num_chains=512, engine="fused",
                 initial_params=zeros, num_warmup=800, discard_initial=800)
    v, mu = flat(res).var(0), flat(res).mean(0)
    print(f"DRAM banana 512x(800+4000): var {v.tolist()} (exact 100, 19), mean {mu.tolist()}")
    check(80.0 < v[0] < 115.0 and 12.0 < v[1] < 26.0 and abs(mu[1]) < 0.6, "DRAM banana bands")

    # split runs: 2n in one call = n, then n resumed from the final state
    for name, mod, spl, init in (("am", corr, AdaptiveMetropolis(), zeros),
                                 ("dram", models["banana"], DRAM(), zeros),
                                 ("dr", models["flagship"], DelayedRejection(rw(0.5), rw(0.1)),
                                  [0.0, 1.0])):
        kw = dict(num_chains=N_CHECK, engine="fused", key=KEY + 103, thinning=2)
        whole = sample(mod, spl, 400, discard_initial=N_WARM, initial_params=init, **kw)
        first = sample(mod, spl, 200, discard_initial=N_WARM, initial_params=init, **kw)
        rest = sample(mod, spl, 200, discard_initial=2, initial_state=first.final_state,
                      iteration_offset=N_WARM - 2 + 400, **kw)
        same = all(torch.equal(torch.cat([getattr(first.transitions, f),
                                          getattr(rest.transitions, f)], 1),
                               getattr(whole.transitions, f))
                   for f in ("params", "lp", "accepted"))
        print(f"{name} split run {N_CHECK} chains, {N_WARM} + 2 x 200 thin 2: bit-exact {same}")
        check(same, f"{name}: the split run differs from the unsplit one")

    for bad, what in ((lambda: sample(corr, AdaptiveMetropolis(pooled=True), 10, num_chains=64,
                                      engine="fused", key=0, initial_params=zeros), "pooled"),
                      (lambda: sample(corr, DRAM(pooled=True), 10, num_chains=64,
                                      engine="fused", key=0, initial_params=zeros), "pooled"),
                      (lambda: sample(models["flagship"], DelayedRejection(
                          RandomWalkProposal(MvNormal(zeros, scale_tril=torch.eye(
                              2, device=DEVICE)), symmetric=True), rw(0.1)), 10, num_chains=64,
                          engine="fused", key=0, initial_params=[0.0, 1.0]), "full-covariance"),
                      (lambda: sample(correlated_gaussian_model(np.eye(9), device=DEVICE),
                                      AdaptiveMetropolis(), 10, num_chains=64, engine="fused",
                                      key=0, initial_params=torch.zeros(9, device=DEVICE)),
                       "d <= 8")):
        try:
            bad()
        except ValueError as e:
            check(what in str(e), f"the {what} error says {e}")
        else:
            fail(f"the fused engine took what it must refuse ({what})")
    print("slice 6 errors: pooled AM and DRAM, a full-covariance DR stage and d = 9 raise")
    sync()


# float32 operations counted from csrc/{am,dr,dram}.cu, csrc/am.cuh and the
# functors, as the earlier bounds (Philox's integer work not counted): the
# correlated Gaussian's density is 2d² + d + 2, the banana's 11, the
# flagship's 5n + 7; a log1m_exp 5; the Welford advance 7 + 11d + d(d+1)/2
# (the shrink of the packed factor) + 3d(d−1) (the sweep's rows below the
# diagonal), 7 + 11d counting the sweep's diagonal and the mean.


def _welford_ops(d: int) -> int:
    return 7 + 11 * d + d * (d + 1) // 2 + 3 * d * (d - 1)


def bound_am(C: int, steps: int, emitted: int, d: int, dens_ops: int, n_consts: int,
             beta: float = 0.05):
    """An AM launch: per step the d normals (12 a pair), the mixture test
    (2), the proposal (2d fixed, d² + 2d adapted, weighted β : 1 − β), the
    density, the accept (5) and the Welford advance. In: x, lp, mean, L, n
    and the constants; out: the draws and the final mean, L and n."""
    prop = beta * 2 * d + (1.0 - beta) * (d * d + 2 * d)
    step = 12 * ((d + 1) // 2) + 2 + prop + dens_ops + 5 + _welford_ops(d)
    nbytes = ((2 * d + d * d + 2) * C * 2 + n_consts + emitted * (d + 2) * C) * 4
    return _bound(nbytes, step * steps * C)


def bound_dram(C: int, steps: int, emitted: int, d: int, dens_ops: int, n_consts: int):
    """A DRAM launch: per step two sets of d normals, the z-space q₁ term
    (7d), two proposals L z (d² + 2d each), two densities, the stage-1 test
    (3), the stage-2 ratio with its two log1m_exp (14) and test (2), and the
    Welford advance; bytes as AM's."""
    step = 24 * ((d + 1) // 2) + 7 * d + 2 * (d * d + 2 * d) + 2 * dens_ops + 3 + 14 + 2
    step += _welford_ops(d)
    nbytes = ((2 * d + d * d + 2) * C * 2 + n_consts + emitted * (d + 2) * C) * 4
    return _bound(nbytes, step * steps * C)


def bound_dr(C: int, steps: int, emitted: int, d: int, dens_ops: int, n_consts: int):
    """A DR launch: per step two sets of d normals, the two candidates (4d),
    two densities, the stage-1 test (3), the two scaled squared distances
    (6d + 2), the stage-2 ratio (14) and test (2). In: x, lp, the two scales
    and the constants; out: the draws."""
    step = 24 * ((d + 1) // 2) + 4 * d + 2 * dens_ops + 3 + 6 * d + 2 + 14 + 2
    return _bound(_io_bytes(C, d, emitted, n_consts + 2 * d), step * steps * C)


def phase_timing_slice6(models, label, errs, times):
    """The three kernels at their main paths' shapes (best of 3) with their
    bounds, the plain versions at the paths' widths over N_PLAIN_SLICE6
    steps, held against the kernel there, and ESS/s of each path including
    summary()."""
    from advancedmh_tpu_torch import (DRAM, AdaptiveMetropolis, DelayedRejection, MvNormal,
                                      RandomWalkProposal, sample)
    from advancedmh_tpu_torch.ops import (AmParams, DramParams, am_sample_reference,
                                          dr_sample_reference, dram_sample_reference,
                                          fused_am_sample, fused_dr_sample, fused_dram_sample)

    C = N_CHAINS
    short = dict(burn=0, n_samples=N_PLAIN_SLICE6)

    def timed(name, fn, plain, args, kw, tag):
        t_k, out = best_of(lambda: fn(*args, **kw))
        del out
        kws = dict(kw, **short)
        t_ks, out = best_of(lambda: fn(*args, **kws))
        t_p, ref = best_of(lambda: plain(*args, **kws), PLAIN_REPEATS)
        print(f"[{label}] {name} {tag}: kernel {t_k * 1e3:.4f} ms; at {C} x {N_PLAIN_SLICE6}: "
              f"kernel {t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
        hold(errs, name, f"{C} x {N_PLAIN_SLICE6}", out, ref)
        return t_k, t_p

    steps = AM_WARM - 1 + AM_DRAWS
    corr_ops = 2 * 2 * 2 + 2 + 2
    for name, fn, plain, key, params, bound_fn in (
            ("am", fused_am_sample, am_sample_reference, "corr_ram", AmParams(), bound_am),
            ("dram", fused_dram_sample, dram_sample_reference, "corr", DramParams(),
             bound_dram)):
        m = models[key]
        x0 = torch.zeros(2, C, device=DEVICE)
        L0 = (torch.eye(2, device=DEVICE) * float(np.float32(0.1 / np.sqrt(2)))).reshape(4, 1)
        args = (m.tile_density, m.cuda_density, x0, m.tile_density(x0, *m.tile_consts),
                x0.clone(), L0.expand(4, C).contiguous(), torch.ones(1, C, device=DEVICE),
                m.tile_consts, KEY)
        kw = dict(burn=AM_WARM - 1, thin=1, n_samples=AM_DRAWS, params=params)
        t_k, t_p = timed(name, fn, plain, args, kw, f"{key} at {C} x ({AM_WARM - 1} + {AM_DRAWS})")
        times[name] = (t_k, t_p, bound_fn(C, steps, AM_DRAWS, 2, corr_ops, 5),
                       f"plain at {C} x {N_PLAIN_SLICE6} steps")
        print(f"[{label}] {name} bound {times[name][2][0] * 1e3:.4f} ms ({times[name][2][1]})")

    flag = models["flagship"]
    p0 = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, C).contiguous()
    args = (flag.tile_density, flag.cuda_density, p0, flag.tile_density(p0, *flag.tile_consts),
            torch.full((2,), DR_SCALES[0], device=DEVICE),
            torch.full((2,), DR_SCALES[1], device=DEVICE), flag.tile_consts, KEY)
    kw = dict(burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_k, t_p = timed("dr", fused_dr_sample, dr_sample_reference, args, kw,
                     f"flagship at {C} x ({N_WARM - 1} + {N_DRAWS})")
    times["dr"] = (t_k, t_p, bound_dr(C, N_WARM - 1 + N_DRAWS, N_DRAWS, 2, 5 * _N_OBS + 7,
                                      _N_OBS), f"plain at {C} x {N_PLAIN_SLICE6} steps")
    print(f"[{label}] dr bound {times['dr'][2][0] * 1e3:.4f} ms ({times['dr'][2][1]})")

    zeros = torch.zeros(2, device=DEVICE)
    rw = lambda s: RandomWalkProposal(MvNormal(zeros, scale=s), symmetric=True)
    for name, m, spl, n_draws, n_warm, init, param in (
            ("am correlated", models["corr_ram"], AdaptiveMetropolis(), AM_DRAWS, AM_WARM, zeros,
             "x0"),
            ("dram correlated", models["corr"], DRAM(), AM_DRAWS, AM_WARM, zeros, "x0"),
            ("dr flagship", flag, DelayedRejection(rw(DR_SCALES[0]), rw(DR_SCALES[1])), N_DRAWS,
             N_WARM, [0.0, 1.0], "μ")):
        time_path(label, f"{name} sample(engine='fused') {C} x ({n_warm} + {n_draws})",
                  lambda: sample(m, spl, n_draws, num_chains=C, engine="fused",
                                 discard_initial=n_warm, initial_params=init, key=KEY + 104,
                                 chain_type="chains", param_names=kw_names(m)), param)


# ---- slice 7: Multiple-Try Metropolis, replica exchange and DE-MC ------------------------

MTM_K = 4  # benchmarks/samplers.py:182-205: MTM(scale 0.2), k = 4 on the flagship
MTM_SCALE = 0.2
MTM_THROUGHPUT_STEPS = 2000
PT_BETAS = tuple(float(b) for b in np.geomspace(1.0, 0.05, 5))  # benchmarks/samplers.py:598-622
PT_SCALE = 0.1
N_PLAIN_SLICE7 = 10  # steps of the slice-7 plain versions timed at the main paths' widths


def mtm_sampler(k=MTM_K, scale=MTM_SCALE):
    from advancedmh_tpu_torch import MultipleTryMetropolis, MvNormal, RandomWalkProposal

    return MultipleTryMetropolis(
        RandomWalkProposal(MvNormal(torch.zeros(2, device=DEVICE), scale=scale)), k=k)


def pt_sampler():
    from advancedmh_tpu_torch import RWMH, MvNormal, ReplicaExchange

    return ReplicaExchange(RWMH(MvNormal(torch.zeros(2, device=DEVICE), scale=PT_SCALE)),
                           betas=PT_BETAS)


def demc_sampler(M=None, **kw):
    """The DE-MC path's population (N_CHAINS members unless ``M``)."""
    from advancedmh_tpu_torch import DifferentialEvolution, InverseGamma, Normal

    return DifferentialEvolution(N_CHAINS if M is None else M,
                                 [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)], **kw)


def _ladder(m, K, C, seed):
    """A ladder of K replicas: each from _start (the flagship: σ ~ U(-0.5, 2),
    some replicas outside the support with ℓ = -inf), N(0, 16) (the bimodal
    target) or N(0, 1), and its raw ℓ."""
    rng = np.random.default_rng(seed)
    if m.cuda_density == "gaussian_mean_scale":
        x = torch.cat([_start(C, seed + k) for k in range(K)])
    else:
        d = m.dimension
        sd = 4.0 if m.cuda_density == "bimodal_mixture" else 1.0
        x = torch.tensor(rng.normal(0.0, sd, (K * d, C)), dtype=torch.float32, device=DEVICE)
    d = x.shape[0] // K
    ell = torch.cat([m.tile_density(x[k * d:(k + 1) * d], *m.tile_consts) for k in range(K)])
    return x, ell


def _demc_start(M, seed):
    """Members s ~ 1 + Gamma(2), m ~ N(0, 1) (benchmarks/samplers.py:398-430)."""
    rng = np.random.default_rng(seed)
    return torch.tensor(np.stack([1.0 + rng.gamma(2.0, size=M), rng.normal(size=M)]),
                        dtype=torch.float32, device=DEVICE)


def hold_population(errs, name, tag, got, ref):
    """A population kernel's outputs against its plain version's: members
    read each other, so one flipped decision spreads; the whole run is held
    to 99.9% of equal decisions and its first 64 draws element-wise (as
    emcee's), the means besides."""
    same = float((got[2] == ref[2]).float().mean())
    r = agreement(tuple(o[:64] for o in got), tuple(o[:64] for o in ref))
    means = [tuple(float(o[0][:, i].mean()) for i in range(o[0].shape[1])) for o in (got, ref)]
    print(f"kernel {name} {tag}: equal decisions {same:.6f}, means {means[0]} / {means[1]}; "
          f"first 64 draws: {r}")
    check(same >= 0.999, f"{name} {tag}: decisions agree {same:.6f} < 0.999")
    check_agreement(f"{name} {tag}, first 64 draws", r, SHORT_RUN_CHAINS_MIN,
                    visible_steps=False)
    check(all(abs(a - b) < 0.05 for a, b in zip(*means)), f"{name} {tag}: means differ")
    errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])


def phase_kernels_slice7(models, errs):
    """The four slice-7 kernels against their plain versions at 64-step
    cases, 2048 chains: MTM sampling on the flagship (diagonal and
    triangular scales, starts outside the support among them) and the
    correlated Gaussians at d = 2, 4 with k = 1, 4, 8, and its throughput
    kernel; tempering on the flagship (K = 5, replicas outside the support),
    the bimodal mixture (K = 5) and a correlated Gaussian with replica
    scales, the final ladder, its ℓ and the swap counts compared; DE-MC on
    the emcee model and a correlated Gaussian, with and without snooker
    moves, one population of 2048 (and 6) members."""
    from advancedmh_tpu_torch.ops import (DemcParams, demc_sample_reference, fused_demc_sample,
                                          fused_mtm, fused_mtm_sample, fused_tempering_sample,
                                          mtm_reference, mtm_sample_reference,
                                          tempering_sample_reference)

    def report(name, tag, got, ref, visible):
        r = agreement(got, ref)
        print(f"kernel {name} {tag}: {r}")
        check_agreement(name, r, SHORT_RUN_CHAINS_MIN, visible_steps=visible)
        errs[name] = max(errs[name], r["max_abs_err"])

    C = 2048
    tril = [[0.2, 0.0], [0.05, 0.15]]
    cases = [  # (model, scale, k, burn, thin, n, offset)
        ("flagship", 0.2, 4, 0, 1, 64, 0),
        ("flagship", tril, 4, 0, 1, 64, (1 << 32) - 30),
        ("flagship", 0.2, 1, 0, 1, 64, 5),
        ("corr", [0.8, 0.6], 8, 5, 3, 19, 7),
        ("corr4", 0.5, 4, 0, 1, 64, 11),
    ]
    for i, (key, scale, k, burn, thin, n, off) in enumerate(cases):
        m = models[key]
        p = _start(C, 150 + i) if key == "flagship" else _gauss_start(m.dimension, C, 150 + i)
        args = (m.tile_density, m.cuda_density, p, m.tile_density(p, *m.tile_consts),
                torch.tensor(scale, device=DEVICE), m.tile_consts, 0x3770 + i)
        kw = dict(k=k, burn=burn, thin=thin, n_samples=n, iteration_offset=off)
        report("mtm_sample", f"{key} C={C} scale {scale} k={k} burn={burn} thin={thin} n={n} "
               f"offset={off}", fused_mtm_sample(*args, **kw), mtm_sample_reference(*args, **kw),
               burn == 0 and thin == 1)
    flag = models["flagship"]
    p = _start(C, 160)
    args = (flag.tile_density, flag.cuda_density, p, flag.tile_density(p, *flag.tile_consts),
            MTM_SCALE, flag.tile_consts, 0x3780)
    report("mtm", f"flagship C={C} k={MTM_K} 64 steps",
           fused_mtm(*args, k=MTM_K, n_steps=64, iteration_offset=3),
           mtm_reference(*args, k=MTM_K, n_steps=64, iteration_offset=3), False)

    pt_cases = [  # (model, betas, scale, replica_scales, burn, thin, n, offset)
        ("flagship", PT_BETAS, PT_SCALE, None, 0, 1, 64, 0),
        ("bimodal", (1.0, 0.55, 0.3, 0.15, 0.05), 0.5, None, 0, 1, 64, (1 << 32) - 30),
        ("corr", (1.0, 0.6, 0.3), [0.8, 0.5], (1.0, 1.3, 1.8), 5, 3, 19, 7),
    ]
    for i, (key, betas, scale, rs, burn, thin, n, off) in enumerate(pt_cases):
        m = models[key]
        x, ell = _ladder(m, len(betas), C, 170 + 10 * i)
        args = (m.tile_density, m.cuda_density, x, ell, m.tile_consts, 0x3790 + i)
        kw = dict(betas=betas, scale=scale, replica_scales=rs, burn=burn, thin=thin, n_samples=n,
                  iteration_offset=off)
        got = fused_tempering_sample(*args, **kw)
        check(not bool(torch.isnan(got[3]).any() or torch.isnan(got[4]).any()),
              f"tempering {key}: NaN in the ladder")
        report("tempering", f"{key} C={C} K={len(betas)} replica scales {rs} burn={burn} "
               f"thin={thin} n={n} offset={off}", got, tempering_sample_reference(*args, **kw),
               burn == 0 and thin == 1)

    de_cases = [  # (model, M, snooker, burn, thin, n, offset)
        ("emcee", 2048, 0.0, 0, 1, 64, 0),
        ("emcee", 2048, 0.3, 3, 2, 30, (1 << 32) - 12),
        ("corr", 2048, 0.5, 0, 1, 64, 9),
        ("emcee", 6, 0.3, 0, 1, 64, 0),
    ]
    for i, (key, M, snooker, burn, thin, n, off) in enumerate(de_cases):
        m = models[key]
        x = _demc_start(M, 180 + i) if key == "emcee" else _gauss_start(2, M, 180 + i)
        args = (m.tile_density, m.cuda_density, x, m.tile_density(x, *m.tile_consts),
                m.tile_consts, 0x37A0 + i)
        kw = dict(params=DemcParams(demc_sampler(M)._gamma(2), snooker_probability=snooker),
                  burn=burn, thin=thin, n_samples=n, iteration_offset=off)
        hold_population(errs, "demc", f"{key} M={M} snooker {snooker} burn={burn} thin={thin} "
                        f"n={n} offset={off}", fused_demc_sample(*args, **kw),
                        demc_sample_reference(*args, **kw))
    sync()


def phase_main_slice7(models, label, launches):
    """MTM (k = 4, scale 0.2) on the flagship with the fused_mtm throughput
    kernel at 16384 x 2000, replica exchange (K = 5, betas geomspace(1,
    0.05), RWMH scale 0.1) on the flagship, and DE-MC on the emcee model
    with one population of 16384 members, each at 16384 x (500 + 4000)
    through sample(engine="fused") + summary() with its launch counters
    read."""
    from advancedmh_tpu_torch import sample, swap_rates
    from advancedmh_tpu_torch.ops import fused_mtm

    flag = models["flagship"]
    mu_q, sig_q = grid_posterior_means(flag.tile_consts[0].cpu().numpy().ravel())
    p0 = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, N_CHAINS).contiguous()
    lp0 = flag.tile_density(p0, *flag.tile_consts)

    reset_launches()
    sync()
    t0 = time.perf_counter()
    res = sample_path(flag, mtm_sampler(), KEY + 110, initial_params=[0.0, 1.0])
    chains = res.to_chains(param_names=["μ", "σ"])
    summary = chains.summary()
    sync()
    t_path = time.perf_counter() - t0
    _, _, acc_b = fused_mtm(flag.tile_density, flag.cuda_density, p0, lp0, MTM_SCALE,
                            flag.tile_consts, KEY, k=MTM_K, n_steps=MTM_THROUGHPUT_STEPS)
    sync()
    got = read_launches()
    check_launches("mtm main path", got, {"mtm_sample": 1, "mtm": 1})
    launches.update(mtm_sample=got["mtm_sample"], mtm=got["mtm"])
    acc = float(res.transitions.accepted.float().mean())
    acc_b_rate = float(acc_b.mean()) / MTM_THROUGHPUT_STEPS
    rhat = max(s["rhat"] for s in summary.values())
    print(f"[{label}] mtm flagship k={MTM_K} first sample(engine='fused') + summary "
          f"{t_path:.4f} s; acceptance {acc:.4f} (fused_mtm {acc_b_rate:.4f}); means "
          f"{summary['μ']['mean']:.5f}, {summary['σ']['mean']:.5f} (quadrature {mu_q:.5f}, "
          f"{sig_q:.5f}); max R-hat {rhat:.5f}; ess(μ)={summary['μ']['ess']:.1f}")
    check(bool(torch.isfinite(chains.values).all()), "mtm: non-finite draws")
    check(0.70 <= acc <= 0.80, f"mtm acceptance {acc} outside [0.70, 0.80]")
    check(0.70 <= acc_b_rate <= 0.80, f"fused_mtm acceptance {acc_b_rate}")
    posterior_check("mtm flagship", summary, mu_q, sig_q)

    res, _, summary, acc = _fused_path("tempering flagship", flag, pt_sampler(), N_DRAWS, N_WARM,
                                       "tempering", launches, label, N_CHAINS, key=KEY + 111,
                                       initial_params=[0.0, 1.0])
    rates = swap_rates(res.final_state)
    fs = res.final_state
    print(f"tempering flagship: means {summary['μ']['mean']:.5f}, {summary['σ']['mean']:.5f} "
          f"(quadrature {mu_q:.5f}, {sig_q:.5f}); cold acceptance {acc:.4f}; swap rates "
          f"{rates.mean(0).tolist()} (min {float(rates.min()):.4f}, max {float(rates.max()):.4f})")
    posterior_check("tempering flagship", summary, mu_q, sig_q)
    check(bool(((rates > 0) & (rates < 1)).all()), "tempering: a swap rate outside (0, 1)")
    check(tuple(fs.inner.params.shape) == (N_CHAINS, len(PT_BETAS), 2), "tempering ladder shape")
    check(bool((fs.swap_proposal_count == N_WARM - 1 + N_DRAWS).all()),
          "tempering: swap proposal count")

    demo = models["emcee"]
    reset_launches()
    sync()
    t0 = time.perf_counter()
    res = sample(demo, demc_sampler(), N_DRAWS, engine="fused", discard_initial=N_WARM,
                 key=KEY + 112)
    chains = res.to_chains(param_names=["s", "m"])
    summary = chains.summary()
    sync()
    t_path = time.perf_counter() - t0
    got = read_launches()
    check_launches("demc main path", got, {"demc": 1})
    launches["demc"] = got["demc"]
    acc = float(res.transitions.accepted.float().mean())
    s_mean, m_mean = summary["s"]["mean"], summary["m"]["mean"]
    print(f"[{label}] demc {N_CHAINS} members first sample(engine='fused') + summary "
          f"{t_path:.4f} s; acceptance {acc:.4f}; means s={s_mean:.5f} (49/24 = {49 / 24:.5f}), "
          f"m={m_mean:.5f} (7/6 = {7 / 6:.5f}); ess(m)={summary['m']['ess']:.1f}")
    check(tuple(res.transitions.params.shape) == (N_DRAWS, N_CHAINS, 2), "demc shape")
    check(bool(torch.isfinite(res.transitions.params).all()), "demc: non-finite draws")
    check(abs(s_mean - 49 / 24) < 0.1 and abs(m_mean - 7 / 6) < 0.1, "demc means")
    check(0.1 < acc < 0.9, f"demc acceptance {acc}")


def sample_path(model, spl, key, **kw):
    """The MTM main path's call: 16384 x (500 + 4000)."""
    from advancedmh_tpu_torch import sample

    return sample(model, spl, N_DRAWS, num_chains=N_CHAINS, engine="fused",
                  discard_initial=N_WARM, key=key, **kw)


def _split_same(whole, first, rest, axis):
    return all(torch.equal(torch.cat([getattr(first.transitions, f),
                                      getattr(rest.transitions, f)], axis),
                           getattr(whole.transitions, f)) for f in ("params", "lp", "accepted"))


def phase_slice7_checks(models):
    """tests/test_pallas.py's card-only MTM, tempering and DE-MC checks at
    their shapes: MTM moments against an engine="torch" run, k = 3 at
    thinning 3, the throughput kernel deterministic; the bimodal mixture at
    1024 x (500 + 4000) from -5 and its split 500 + 2000 + 2000 run bit for
    bit with 4499 swap proposals; DE-MC at 1024 members (thinning 3, snooker
    0.3); split runs of MTM and DE-MC bit for bit."""
    from advancedmh_tpu_torch import RWMH, Normal, ReplicaExchange, sample, swap_rates
    from advancedmh_tpu_torch.ops import fused_mtm

    flag, demo = models["flagship"], models["emcee"]
    start = [0.0, 1.0]
    c = sample(flag, mtm_sampler(), 2000, key=3, num_chains=N_CHECK, engine="fused",
               discard_initial=1000, initial_params=start, chain_type="chains",
               param_names=["μ", "σ"])
    ref = sample(flag, mtm_sampler(), 2000, key=3, num_chains=256, discard_initial=1000,
                 initial_params=start, chain_type="chains", param_names=["μ", "σ"])
    d_mu, d_sig = (abs(float(c[n].mean()) - float(ref[n].mean())) for n in ("μ", "σ"))
    print(f"MTM {N_CHECK}x(1000+2000) fused vs engine=torch 256 chains: |Δμ| {d_mu:.5f}, "
          f"|Δσ| {d_sig:.5f}")
    check(d_mu < 0.05 and d_sig < 0.05, "MTM fused vs torch engine moments")
    res = sample(flag, mtm_sampler(k=3), 100, key=11, num_chains=256, engine="fused",
                 discard_initial=50, thinning=3, initial_params=start)
    check(tuple(res.transitions.params.shape) == (256, 100, 2), "MTM thin 3 shape")
    check(bool(torch.isfinite(res.transitions.lp).all()), "MTM thin 3: non-finite lp")
    p = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, 256).contiguous()
    args = (flag.tile_density, flag.cuda_density, p, flag.tile_density(p, *flag.tile_consts),
            0.2, flag.tile_consts, 3)
    p1, _, _ = fused_mtm(*args, k=4, n_steps=50)
    p2, _, _ = fused_mtm(*args, k=4, n_steps=50)
    check(torch.equal(p1, p2), "fused_mtm is not deterministic")

    bi = models["bimodal"]
    pt = ReplicaExchange(RWMH(Normal(0.0, 0.5)), betas=(1.0, 0.55, 0.3, 0.15, 0.05))
    kw = dict(key=0, num_chains=1024, engine="fused", initial_params=[-5.0])
    whole = sample(bi, pt, 4000, discard_initial=500, **kw)
    draws = whole.transitions.params[..., 0]
    frac_right = (draws > 0).float().mean(1)
    want = bi.tile_density(whole.transitions.params.reshape(1, -1)).reshape(draws.shape)
    lp_err = float((whole.transitions.lp - want).abs().max())
    rates = swap_rates(whole.final_state)
    print(f"tempering bimodal 1024x(500+4000) from -5: frac right {float(frac_right.mean()):.4f},"
          f" chains crossing {float((frac_right > 0.02).float().mean()):.4f}, mean "
          f"{float(draws.mean()):.4f}, cold lp vs density max |err| {lp_err:.3g}, swap rates "
          f"{rates.mean(0).tolist()}")
    check(0.3 < float(frac_right.mean()) < 0.7, "tempering bimodal: mode balance")
    check(float((frac_right > 0.02).float().mean()) > 0.95, "tempering bimodal: crossings")
    check(abs(float(draws.mean())) < 1.0, "tempering bimodal: mean")
    check(torch.allclose(whole.transitions.lp, want, rtol=1e-4, atol=1e-4),
          "tempering bimodal: cold lp is not the untempered density")
    check(tuple(rates.shape) == (1024, 4) and bool(((rates > 0) & (rates < 1)).all()),
          "tempering bimodal: swap rates")
    first = sample(bi, pt, 2000, discard_initial=500, **kw)
    rest = sample(bi, pt, 2000, discard_initial=1, initial_state=first.final_state,
                  iteration_offset=499 + 2000, **{**kw, "initial_params": None})
    same = _split_same(whole, first, rest, 1)
    prop = rest.final_state.swap_proposal_count
    same_state = (torch.equal(rest.final_state.inner.params, whole.final_state.inner.params)
                  and torch.equal(rest.final_state.swap_accept_count,
                                  whole.final_state.swap_accept_count))
    print(f"tempering split 500 + 2000 + 2000: bit-exact {same}, ladders and swap counts equal "
          f"{same_state}, swap proposals {int(prop.min())}..{int(prop.max())}")
    check(same and same_state, "tempering: the split run differs from the unsplit one")
    check(bool((prop == 499 + 2000 + 2000).all()), "tempering: swap proposals across the split")

    res = sample(demo, demc_sampler(1024), 1000, key=100, engine="fused", discard_initial=200)
    dr = res.transitions.params.reshape(-1, 2)
    acc = float(res.transitions.accepted.float().mean())
    res_t = sample(demo, demc_sampler(1024), 200, key=101, engine="fused", discard_initial=100,
                   thinning=3)
    dt = res_t.transitions.params.reshape(-1, 2)
    res_s = sample(demo, demc_sampler(1024, snooker_probability=0.3), 1000, key=100,
                   engine="fused", discard_initial=200)
    ds = res_s.transitions.params.reshape(-1, 2)
    acc_s = float(res_s.transitions.accepted.float().mean())
    print(f"DE-MC 1024 members (200+1000): means {dr.mean(0).tolist()}, acceptance {acc:.4f}; "
          f"thin 3: {dt.mean(0).tolist()}; snooker 0.3: {ds.mean(0).tolist()}, acceptance "
          f"{acc_s:.4f}")
    for name, dd, tol in (("DE-MC", dr, 0.1), ("DE-MC thin 3", dt, 0.12),
                          ("DE-MC snooker", ds, 0.1)):
        check(abs(float(dd[:, 0].mean()) - 49 / 24) < tol
              and abs(float(dd[:, 1].mean()) - 7 / 6) < tol, f"{name} means")
    check(0.1 < acc < 0.9 and 0.1 < acc_s < 0.9, "DE-MC acceptance")
    check(tuple(res.transitions.params.shape) == (1000, 1024, 2)
          and tuple(res.final_state.params.shape) == (1024, 2), "DE-MC shapes")

    # split runs: 2n in one call = n, then n resumed from the final state
    for name, run, axis in (
            ("mtm", lambda n, d, **k: sample(flag, mtm_sampler(), n, num_chains=N_CHECK,
                                             engine="fused", key=KEY + 113, thinning=2,
                                             discard_initial=d, **k), 1),
            ("demc", lambda n, d, **k: sample(demo, demc_sampler(N_CHECK, snooker_probability=0.3),
                                              n, engine="fused", key=KEY + 114, thinning=2,
                                              discard_initial=d, **k), 0)):
        init = dict(initial_params=start) if name == "mtm" else {}
        whole = run(400, N_WARM, **init)
        first = run(200, N_WARM, **init)
        rest = run(200, 2, initial_state=first.final_state, iteration_offset=N_WARM - 2 + 400)
        same = _split_same(whole, first, rest, axis)
        print(f"{name} split run {N_CHECK}, {N_WARM} + 2 x 200 thin 2: bit-exact {same}")
        check(same, f"{name}: the split run differs from the unsplit one")
    sync()


# float32 operations counted from csrc/{mtm,tempering,demc}.cu and the
# functors, as the earlier bounds (Philox's integer work not counted): the
# flagship's density 5n + 7 at its n = 30 observations, the emcee model's 18;
# a Box-Muller pair 12 and a log 1.


def bound_mtm(C: int, steps: int, emitted: int, k: int, d: int = 2, throughput: bool = False):
    """An MTM launch: per step 2k − 1 densities with their clamp (5n + 8),
    normals (12 a pair) and proposals (2d); k Gumbel draws (2 logs, a
    negation, an add, a compare and d + 2 selects); 2k − 2 terms of the two
    streaming logsumexps (7 each: max, two subtractions, two exps, a
    multiply and an add); log α (two logs, three adds); the accept (a log,
    a compare, d + 1 selects). In: x, lp, the scale and the constants; out:
    the draws (or the final state and counts)."""
    P = (d + 1) // 2
    step = ((2 * k - 1) * (5 * _N_OBS + 8 + 12 * P + 2 * d) + k * (6 + d) + (2 * k - 2) * 7
            + 5 + d + 3)
    out = (d + 2) * C if throughput else emitted * (d + 2) * C
    return _bound(((d + 1) * C + d + _N_OBS + out) * 4, step * steps * C)


def bound_tempering(C: int, steps: int, emitted: int, K: int, d: int = 2):
    """A tempering launch: per step K moves (normals 12 a pair, proposal 2d,
    the density 5n + 7, β(ℓ_y − ℓ), a log, a compare and d + 1 selects) and
    K − 1 swap tests (two operations, a log, a compare, 2d + 2 selects and
    the count). In: the ladder (K d + K a chain), β, the scales and the
    constants; out: the cold replica's draws and the final ladder with its
    swap counts."""
    P = (d + 1) // 2
    step = K * (12 * P + 2 * d + 5 * _N_OBS + 7 + 2 + 2 + d + 1) + (K - 1) * (2 + 2 + 2 * d + 3)
    nbytes = ((K * d + K) * C * 2 + (K - 1) * C + 2 * K + K * d + _N_OBS
              + emitted * (d + 2) * C) * 4
    return _bound(nbytes, step * steps * C)


def bound_demc(M: int, steps: int, emitted: int, d: int = 2, dens_ops: int = 18):
    """A DE-MC launch: per member-step the three index draws (2 each, the
    bump 1), the jump (2), d normals (12 a pair), the proposal (4d), the
    density and the accept (a log, three adds and compares, d + 1 selects).
    In: the population (d + 1 a member); out: the draws."""
    step = 7 + 2 + 12 * ((d + 1) // 2) + 4 * d + dens_ops + 4 + d + 1
    return _bound(((d + 1) * M + emitted * (d + 2) * M) * 4, step * steps * M)


def phase_timing_slice7(models, label, errs, times):
    """The four kernels at their main paths' shapes (best of 3) with their
    bounds, the plain versions at the paths' widths over N_PLAIN_SLICE7
    steps held against the kernel there, DE-MC's plain version over the
    whole run held as emcee's, and ESS/s of each path including
    summary()."""
    from advancedmh_tpu_torch import sample
    from advancedmh_tpu_torch.ops import (DemcParams, demc_sample_reference, fused_demc_sample,
                                          fused_mtm, fused_mtm_sample, fused_tempering_sample,
                                          mtm_reference, mtm_sample_reference,
                                          tempering_sample_reference)

    C = N_CHAINS
    flag, demo = models["flagship"], models["emcee"]
    short = dict(burn=0, n_samples=N_PLAIN_SLICE7)
    steps = N_WARM - 1 + N_DRAWS

    def timed(name, fn, plain, args, kw, kws, tag):
        t_k, out = best_of(lambda: fn(*args, **kw))
        del out
        t_ks, out = best_of(lambda: fn(*args, **kws))
        t_p, ref = best_of(lambda: plain(*args, **kws), PLAIN_REPEATS)
        print(f"[{label}] {name} {tag}: kernel {t_k * 1e3:.4f} ms; at {C} x {N_PLAIN_SLICE7}: "
              f"kernel {t_ks * 1e3:.4f} ms, plain {t_p * 1e3:.4f} ms")
        hold(errs, name, f"{C} x {N_PLAIN_SLICE7}", out, ref)
        return t_k, t_p

    p0 = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, C).contiguous()
    args = (flag.tile_density, flag.cuda_density, p0, flag.tile_density(p0, *flag.tile_consts),
            MTM_SCALE, flag.tile_consts, KEY)
    kw = dict(k=MTM_K, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_k, t_p = timed("mtm_sample", fused_mtm_sample, mtm_sample_reference, args, kw,
                     dict(kw, **short), f"flagship k={MTM_K} at {C} x ({N_WARM - 1} + {N_DRAWS})")
    times["mtm_sample"] = (t_k, t_p, bound_mtm(C, steps, N_DRAWS, MTM_K),
                           f"plain at {C} x {N_PLAIN_SLICE7} steps")
    kw = dict(k=MTM_K, n_steps=MTM_THROUGHPUT_STEPS)
    t_k, t_p = timed("mtm", fused_mtm, mtm_reference, args, kw,
                     dict(k=MTM_K, n_steps=N_PLAIN_SLICE7),
                     f"flagship k={MTM_K} at {C} x {MTM_THROUGHPUT_STEPS}")
    times["mtm"] = (t_k, t_p, bound_mtm(C, MTM_THROUGHPUT_STEPS, 0, MTM_K, throughput=True),
                    f"plain at {C} x {N_PLAIN_SLICE7} steps")
    print(f"[{label}] fused_mtm {C * MTM_THROUGHPUT_STEPS / t_k:.6e} chain-steps/s")

    K = len(PT_BETAS)
    x0 = p0.repeat(K, 1).contiguous()
    args = (flag.tile_density, flag.cuda_density, x0,
            flag.tile_density(p0, *flag.tile_consts).expand(K, C).contiguous(), flag.tile_consts,
            KEY)
    kw = dict(betas=PT_BETAS, scale=PT_SCALE, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_k, t_p = timed("tempering", fused_tempering_sample, tempering_sample_reference, args, kw,
                     dict(kw, **short), f"flagship K={K} at {C} x ({N_WARM - 1} + {N_DRAWS})")
    times["tempering"] = (t_k, t_p, bound_tempering(C, steps, N_DRAWS, K),
                          f"plain at {C} x {N_PLAIN_SLICE7} steps")

    spl = demc_sampler()
    x = _demc_start(C, KEY)
    args = (demo.tile_density, demo.cuda_density, x, demo.tile_density(x), (), KEY)
    kw = dict(params=DemcParams(spl._gamma(2)), burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_k, out = best_of(lambda: fused_demc_sample(*args, **kw))
    t_p, ref = best_of(lambda: demc_sample_reference(*args, **dict(kw, **short)), PLAIN_REPEATS)
    t_pf, ref_full = best_of(lambda: demc_sample_reference(*args, **kw), PLAIN_REPEATS)
    print(f"[{label}] demc at {C} members x ({N_WARM - 1} + {N_DRAWS}): kernel {t_k * 1e3:.4f} "
          f"ms ({C * steps / t_k:.6e} member-steps/s); plain {t_p * 1e3:.4f} ms at {C} x "
          f"{N_PLAIN_SLICE7}, {t_pf * 1e3:.4f} ms over the whole run")
    hold_population(errs, "demc", f"{C} x ({N_WARM - 1} + {N_DRAWS})", out, ref_full)
    del out, ref, ref_full
    times["demc"] = (t_k, t_p, bound_demc(C, steps, N_DRAWS),
                     f"plain at {C} x {N_PLAIN_SLICE7} steps")
    for name in ("mtm_sample", "mtm", "tempering", "demc"):
        print(f"[{label}] {name} bound {times[name][2][0] * 1e3:.4f} ms ({times[name][2][1]})")

    time_path(label, f"mtm sample(engine='fused') {C} x ({N_WARM} + {N_DRAWS})",
              lambda: sample_path(flag, mtm_sampler(), KEY + 115, initial_params=[0.0, 1.0],
                                  chain_type="chains", param_names=["μ", "σ"]), "μ")
    time_path(label, f"tempering sample(engine='fused') {C} x ({N_WARM} + {N_DRAWS}), cold replica",
              lambda: sample_path(flag, pt_sampler(), KEY + 116, initial_params=[0.0, 1.0],
                                  chain_type="chains", param_names=["μ", "σ"]), "μ")
    time_path(label, f"demc sample(engine='fused') {C} members x ({N_WARM} + {N_DRAWS})",
              lambda: sample(demo, demc_sampler(), N_DRAWS, engine="fused", discard_initial=N_WARM,
                             key=KEY + 117, chain_type="chains", param_names=["s", "m"]), "m")


# ---- slice 8: the power-posterior (evidence) kernel, AIS and SMC ------------------------

EV_CHAINS = 512  # chains a rung on the logistic regression: 16 x 512 = 8192, the port's other
EV_STEPS = 3000  # logistic-regression paths' chain count; 3000 burn-in + 3000 draws
EV_PRIOR_SCALE = 10.0  # the model's own N(0, 10^2 I) prior, passed apart from the likelihood
EV_CONJ_CHAINS = 256  # bench.py:513-550: 16 rungs x 256 chains, 3000 + 3000
Y_CONJ = [0.8, 1.3, 0.2, 1.0, 0.6]  # tests/test_evidence.py's conjugate data
N_PLAIN_EV = 10  # steps of the evidence plain version timed at the main path's width


def _analytic_log_evidence(y, sigma, tau):
    """log N(y; 0, σ²I + τ²11ᵀ), the conjugate Normal-Normal evidence."""
    y = np.asarray(y, np.float64)
    n = len(y)
    cov = sigma**2 * np.eye(n) + tau**2 * np.ones((n, n))
    _, logdet = np.linalg.slogdet(2.0 * np.pi * cov)
    return float(-0.5 * (logdet + y @ np.linalg.solve(cov, y)))


def _ev_inputs(m, C, seed, s, beta_zero_chain=True):
    """A ladder batch for the kernel: x (d, C) ~ N(0, s²), its ll and prior
    lp, a β row drawn from power_ladder() (chain 0 with β = 0 beside
    ll = -inf when ``beta_zero_chain``), and the prior's columns."""
    from advancedmh_tpu_torch import power_ladder
    from advancedmh_tpu_torch.ops import gaussian_prior_lp

    d = m.dimension
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0.0, s, (d, C)), dtype=torch.float32, device=DEVICE)
    loc = torch.zeros(d, device=DEVICE)
    scale = torch.full((d,), float(s), device=DEVICE)
    ll = m.tile_density(x, *m.tile_consts)
    beta = torch.tensor(rng.choice(power_ladder(), C)[None], dtype=torch.float32, device=DEVICE)
    if beta_zero_chain:
        ll[0, 0] = -float("inf")
        beta[0, 0] = 0.0
    plp = gaussian_prior_lp(x, loc[:, None], scale[:, None], torch.log(scale)[:, None])
    return x, ll, plp, beta, loc, scale


def _ev_eps0(C, per_rung, seed):
    if not per_rung:
        return torch.full((1, C), 0.5, device=DEVICE)
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(0.02, 0.6, (1, C)), dtype=torch.float32, device=DEVICE)


def phase_kernels_slice8(models, errs):
    """The evidence kernel against its plain version at short cases, 2048
    chains: the conjugate Normal mean (d = 1), the flat likelihood (d = 2)
    and the logistic regression (d = 32); adaptation on and off, one ε₀ and
    per-chain ε₀, thin 1 and 3, an offset across 2³², and a β = 0 chain
    beside ll = -inf (it must never accept). Held as every sampling kernel:
    the emitted log-likelihoods as its states and lp, the accept flags as
    its decisions, the frozen ε̄ as a final output."""
    from advancedmh_tpu_torch.ops import fused_power_rwmh_sample, power_rwmh_reference

    C = 2048
    cases = [  # (model, prior scale, adapt, per-chain eps0, burn, thin, n, offset)
        ("conj", 1.0, True, False, 32, 1, 64, 0),
        ("conj", 1.0, False, True, 0, 1, 64, (1 << 32) - 30),
        ("flat2", 1.0, True, True, 16, 3, 21, 5),
        ("flat2", 1.0, False, False, 0, 1, 64, 0),
        ("logreg_lik", EV_PRIOR_SCALE, True, False, 40, 1, 32, (1 << 32) - 20),
        ("logreg_lik", EV_PRIOR_SCALE, False, True, 5, 3, 11, 9),
    ]
    for i, (key, s, adapt, per_rung, burn, thin, n, off) in enumerate(cases):
        m = models[key]
        x, ll, plp, beta, loc, scale = _ev_inputs(m, C, 190 + i, s)
        args = (m.tile_density, m.cuda_density, x, ll, plp, beta, _ev_eps0(C, per_rung, i), loc,
                scale, m.tile_consts, 0x3800 + i)
        kw = dict(n_samples=n, burn=burn, thin=thin, adapt=adapt, iteration_offset=off)
        got = fused_power_rwmh_sample(*args, **kw)
        ref = power_rwmh_reference(*args, **kw)
        check(got[0].shape == (n, 1, C) and got[2].shape == (1, C), "evidence output shapes")
        r = agreement((got[0], got[0], got[1], got[2]), (ref[0], ref[0], ref[1], ref[2]))
        print(f"kernel evidence {key} C={C} adapt={adapt} per-chain eps0={per_rung} "
              f"burn={burn} thin={thin} n={n} offset={off}: {r}")
        check_agreement("evidence", r, SHORT_RUN_CHAINS_MIN, visible_steps=burn == 0 and thin == 1)
        check(bool((got[1][:, 0, 0] == 0).all() and (got[0][:, 0, 0] == -float("inf")).all()),
              "evidence: the β = 0 chain beside ll = -inf accepted")
        errs["evidence"] = max(errs["evidence"], r["max_abs_err"])
    sync()


def laplace_log_evidence(X: np.ndarray, y: np.ndarray, prior_scale: float) -> float:
    """log Z of the logistic regression by the Laplace approximation at the
    MAP (Newton in float64): log L(b*) + log p(b*) + (d/2) log 2π − ½ log|H|."""
    X, y = X.astype(np.float64), y.astype(np.float64)
    d = X.shape[1]
    iv = 1.0 / prior_scale**2
    b = np.zeros(d)
    for _ in range(100):
        p = 1.0 / (1.0 + np.exp(-(X @ b)))
        H = (X * (p * (1.0 - p))[:, None]).T @ X + iv * np.eye(d)
        b = b + np.linalg.solve(H, X.T @ (y - p) - iv * b)
    z = X @ b
    p = 1.0 / (1.0 + np.exp(-z))
    H = (X * (p * (1.0 - p))[:, None]).T @ X + iv * np.eye(d)
    log_l = float(np.sum(y * z - np.logaddexp(0.0, z)))
    log_p = float(-0.5 * iv * b @ b - 0.5 * d * np.log(2.0 * np.pi * prior_scale**2))
    return log_l + log_p + 0.5 * d * np.log(2.0 * np.pi) - 0.5 * float(np.linalg.slogdet(H)[1])


def _ev_prior(d, s):
    from advancedmh_tpu_torch import MvNormal

    return MvNormal(torch.zeros(d, device=DEVICE), scale=s)


def phase_main_slice8(models, label, launches):
    """log_evidence on the d = 32 logistic regression (256 observations,
    seed 0; the likelihood at prior_scale=inf, the prior its own N(0, 10²I)
    passed apart): power_ladder() (16 rungs) x 512 chains, 3000 + 3000,
    proposal_scale="auto", on engine="fused" (one kernel launch), then on
    engine="torch" with another key. Stepping-stone within 4 combined SEs,
    TI within the same bound (its Monte-Carlo error is the stepping-stone's
    to first order: the same draws, the same rung weights up to the
    trapezoid's split), every rung's acceptance > 0.1, the adapted scales
    smaller on the β = 1 rung than on the prior's. The fused call is timed
    best of 3, the first call beside it."""
    from advancedmh_tpu_torch import log_evidence

    lik = models["logreg_lik"]
    prior = _ev_prior(32, EV_PRIOR_SCALE)
    run = lambda key, engine: log_evidence(lik, prior, EV_STEPS, key=key, num_chains=EV_CHAINS,
                                           engine=engine)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    fused = run(KEY + 120, "fused")
    sync()
    t_first = time.perf_counter() - t0
    got = read_launches()
    check_launches("evidence main path", got, {"evidence": 1})
    launches["evidence"] = got["evidence"]
    t_best, _ = best_of(lambda: run(KEY + 120, "fused"), 2)
    t_best = min(t_best, t_first)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    ref = run(KEY + 121, "torch")
    sync()
    t_torch = time.perf_counter() - t0
    check_launches("evidence engine='torch'", read_launches(), {})
    X, y = (c.cpu().numpy() for c in lik.tile_consts[:2])
    laplace = laplace_log_evidence(X, y.ravel(), EV_PRIOR_SCALE)
    B = 16 * EV_CHAINS
    print(f"[{label}] log_evidence(engine='fused') logistic regression 16 x {EV_CHAINS} "
          f"({B} chains) x ({EV_STEPS} + {EV_STEPS}): first call {t_first:.4f} s, best of 3 "
          f"{t_best:.4f} s; engine='torch' {t_torch:.4f} s")
    for name, o in (("fused", fused), ("torch", ref)):
        print(f"evidence {name}: log_z_ss {o['log_z_ss']:.5f} (se {o['se_ss']:.5f}), log_z_ti "
              f"{o['log_z_ti']:.5f}; acceptance {np.round(o['acceptance'], 4).tolist()}; "
              f"scales {np.round(o['proposal_scales'], 5).tolist()}")
    print(f"evidence logistic regression: Laplace approximation at the MAP {laplace:.5f} "
          "(not a gate)")
    se = float(np.hypot(fused["se_ss"], ref["se_ss"]))
    for est in ("log_z_ss", "log_z_ti"):
        diff = abs(fused[est] - ref[est])
        check(np.isfinite(fused[est]) and diff < 4.0 * se,
              f"evidence {est}: fused {fused[est]} vs torch {ref[est]} (4 combined SE {4 * se})")
    for name, o in (("fused", fused), ("torch", ref)):
        check(bool(np.all(o["acceptance"] > 0.1)), f"evidence {name}: a rung's acceptance <= 0.1")
        check(o["proposal_scales"][-1] < o["proposal_scales"][0],
              f"evidence {name}: the adapted scales do not fall along the ladder")
    return t_first, t_best


def phase_slice8_checks(models):
    """tests/test_pallas.py's card-only evidence checks at their shapes, and
    tests/test_evidence.py's AIS and tests/test_smc.py's SMC checks on the
    card: the fused conjugate Normal-Normal at 16 x 256 x (3000 + 3000)
    within 3·se_ss + 0.02 of the closed form, TI within 0.1, every rung's
    acceptance in (0.15, 0.35); the flat likelihood |log Z| < 1e-5; an
    InverseGamma prior raising; AIS within 0.05 and 3·SE + 0.02 with weight
    ESS > 100; SMC's evidence within 0.05 and posterior mean and sd within
    0.03."""
    from advancedmh_tpu_torch import InverseGamma, log_evidence, log_evidence_ais, smc_sample

    conj, flat = models["conj"], models["flat2"]
    want = _analytic_log_evidence(Y_CONJ, 1.0, 1.0)
    out = log_evidence(conj, _ev_prior(1, 1.0), 3000, key=0, num_chains=EV_CONJ_CHAINS,
                       engine="fused")
    err = abs(out["log_z_ss"] - want)
    print(f"evidence fused conjugate 16 x {EV_CONJ_CHAINS} x (3000 + 3000): log_z_ss "
          f"{out['log_z_ss']:.5f} (closed form {want:.5f}, se {out['se_ss']:.5f}), log_z_ti "
          f"{out['log_z_ti']:.5f}, acceptance {np.round(out['acceptance'], 4).tolist()}")
    check(err < 3.0 * out["se_ss"] + 0.02, f"fused conjugate: |err| {err}")
    check(abs(out["log_z_ti"] - want) < 0.1, "fused conjugate: TI off by 0.1 or more")
    check(bool(np.all((out["acceptance"] > 0.15) & (out["acceptance"] < 0.35))),
          "fused conjugate: a rung's acceptance outside (0.15, 0.35)")
    out = log_evidence(flat, _ev_prior(2, 1.0), 200, key=1, num_chains=64, engine="fused")
    print(f"evidence fused flat likelihood: log_z_ss {out['log_z_ss']!r}, log_z_ti "
          f"{out['log_z_ti']!r}")
    check(abs(out["log_z_ss"]) < 1e-5 and abs(out["log_z_ti"]) < 1e-5, "fused flat: log Z != 0")
    try:
        log_evidence(flat, InverseGamma(2.0, 3.0), 100, key=2, num_chains=64, engine="fused")
        fail("fused log_evidence took an InverseGamma prior")
    except ValueError as e:
        check("MvNormal prior" in str(e), f"fused InverseGamma error: {e}")
    ais = log_evidence_ais(conj, _ev_prior(1, 1.0), key=0, num_chains=512, n_steps_per_rung=4,
                           proposal_scale=0.6)
    err = abs(ais["log_z_ais"] - want)
    print(f"evidence AIS on the card: log_z_ais {ais['log_z_ais']:.5f} (se {ais['se_ais']:.5f}), "
          f"ess_weights {ais['ess_weights']:.1f}")
    check(err < 0.05 and err < 3.0 * ais["se_ais"] + 0.02, f"AIS: |err| {err}")
    check(ais["ess_weights"] > 100.0, "AIS: weight ESS <= 100")
    t0 = time.perf_counter()
    smc = smc_sample(conj, _ev_prior(1, 1.0), key=0, num_particles=8192)
    sync()
    t_smc = time.perf_counter() - t0
    th = smc["particles"].reshape(-1).double()
    n = len(Y_CONJ)
    mean, sd = float(th.mean()), float(th.std(correction=0))
    print(f"SMC on the card (8192 particles, {smc['n_stages']} stages, {t_smc:.4f} s): log_z "
          f"{smc['log_z']:.5f}, posterior mean {mean:.5f} (closed form "
          f"{sum(Y_CONJ) / (n + 1):.5f}), sd {sd:.5f} ({(1.0 / (n + 1)) ** 0.5:.5f}), acceptance "
          f"{np.round(smc['acceptance'], 4).tolist()}")
    check(abs(smc["log_z"] - want) < 0.05, "SMC: log Z off by 0.05 or more")
    check(abs(mean - sum(Y_CONJ) / (n + 1)) < 0.03, "SMC: posterior mean")
    check(abs(sd - (1.0 / (n + 1)) ** 0.5) < 0.03, "SMC: posterior sd")


def logreg_logp_ops(d: int, n: int) -> int:
    """The logistic regression's log density at d coefficients and n
    observations, counted from csrc/common.cuh: per observation the logit's
    2d − 1 and nine for the term (abs, negation, exp, multiply, max,
    log1p and three adds); per evaluation the partials' 7, b·b (2d − 1)
    and the prior term's 3."""
    return n * ((2 * d - 1) + 9) + 2 * d + 10


def bound_evidence(C: int, steps: int, emitted: int, d: int, dens_ops: int, n_consts: int,
                   burn: int = 0):
    """An evidence launch: per chain-step the noise (12 a Box-Muller pair and
    3), the proposal (2d), the likelihood (``dens_ops``), the prior (7 a
    coordinate: subtract, divide, two multiplies, two subtractions, the add),
    the accept (two multiplies, three adds and subtractions, a compare) and
    d + 2 selects; a burn-in step adds ε = exp(log ε) and the dual
    averaging (19). In: x, ll, lp, β and ε₀ (d + 4 floats a chain), the
    constants and the prior's columns; out: 2 floats a chain and draw and ε̄."""
    step = _noise_ops(d) + 2 * d + dens_ops + 7 * d + 6 + d + 2
    nbytes = ((d + 4) * C + n_consts + 2 * d + 2 * emitted * C + C) * 4
    return _bound(nbytes, (step * steps + 20 * burn) * C)


def phase_timing_slice8(models, label, errs, times):
    """The evidence kernel at the main path's shape (16 x 512 chains, 3000 +
    3000, adaptation on; best of 3) with its bound, and the plain version at
    the same width over N_PLAIN_EV steps, held against the kernel there."""
    from advancedmh_tpu_torch.ops import fused_power_rwmh_sample, power_rwmh_reference

    m = models["logreg_lik"]
    C = 16 * EV_CHAINS
    x, ll, plp, beta, loc, scale = _ev_inputs(m, C, KEY, EV_PRIOR_SCALE, beta_zero_chain=False)
    args = (m.tile_density, m.cuda_density, x, ll, plp, beta, _ev_eps0(C, False, 0), loc, scale,
            m.tile_consts, KEY)
    kw = dict(n_samples=EV_STEPS, burn=EV_STEPS, adapt=True)
    t_k, out = best_of(lambda: fused_power_rwmh_sample(*args, **kw))
    check(bool(torch.isfinite(out[0]).all()), "evidence kernel: non-finite ll at the main shape")
    acc = float(out[1].mean())
    del out
    short = dict(n_samples=N_PLAIN_EV // 2, burn=N_PLAIN_EV // 2, adapt=True)
    t_ks, got = best_of(lambda: fused_power_rwmh_sample(*args, **short))
    t_p, ref = best_of(lambda: power_rwmh_reference(*args, **short), PLAIN_REPEATS)
    hold(errs, "evidence", f"{C} x {N_PLAIN_EV}", (got[0], got[0], got[1], got[2]),
         (ref[0], ref[0], ref[1], ref[2]))
    n_consts = sum(c.numel() for c in m.tile_consts)
    times["evidence"] = (t_k, t_p, bound_evidence(C, 2 * EV_STEPS, EV_STEPS, 32,
                                                  logreg_logp_ops(32, 256), n_consts,
                                                  burn=EV_STEPS),
                         f"plain at {C} x {N_PLAIN_EV} steps")
    print(f"[{label}] evidence logistic regression at {C} x ({EV_STEPS} + {EV_STEPS}): kernel "
          f"{t_k * 1e3:.4f} ms ({C * 2 * EV_STEPS / t_k:.6e} chain-steps/s, acceptance "
          f"{acc:.4f}); at {C} x {N_PLAIN_EV}: kernel {t_ks * 1e3:.4f} ms, plain "
          f"{t_p * 1e3:.4f} ms; bound {times['evidence'][2][0] * 1e3:.4f} ms "
          f"({times['evidence'][2][1]})")


# ---- timing ------------------------------------------------------------------------


def hold(errs, name, tag, got, ref):
    """Timed outputs at the main path's shapes against the plain version's,
    with the long-run tolerance."""
    r = agreement(got, ref)
    print(f"kernel {name} {tag}: {r}")
    check_agreement(f"{name} {tag}", r, LONG_RUN_CHAINS_MIN, visible_steps=False)
    errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])


def phase_timing_rwmh(model, spl, p0, lp0, label, errs, times):
    from advancedmh_tpu_torch import ess_bulk, sample
    from advancedmh_tpu_torch.ops import (fused_rwmh, fused_rwmh_sample,
                                          rwmh_reference, rwmh_sample_reference)

    args = (model.tile_density, model.cuda_density, p0, lp0, SCALE, model.tile_consts, KEY)
    t_b, out_b = best_of(lambda: fused_rwmh(*args, n_steps=N_STEPS_THROUGHPUT))
    rate_b = N_CHAINS * N_STEPS_THROUGHPUT / t_b
    print(f"[{label}] rwmh kernel: {rate_b:.6e} chain-steps/s "
          f"({N_CHAINS} x {N_STEPS_THROUGHPUT}, {t_b * 1e3:.4f} ms, best of 3)")
    hold(errs, "rwmh", f"{N_CHAINS} x {N_STEPS_THROUGHPUT}", out_b,
         rwmh_reference(*args, n_steps=N_STEPS_THROUGHPUT))
    n_plain = 500
    t_b500, out_b500 = best_of(lambda: fused_rwmh(*args, n_steps=n_plain))
    t_b500_plain, ref_b500 = best_of(lambda: rwmh_reference(*args, n_steps=n_plain),
                                     PLAIN_REPEATS)
    print(f"[{label}] rwmh at {N_CHAINS} x {n_plain}: kernel {t_b500 * 1e3:.4f} ms "
          f"({N_CHAINS * n_plain / t_b500:.6e} chain-steps/s), plain "
          f"{t_b500_plain * 1e3:.4f} ms ({N_CHAINS * n_plain / t_b500_plain:.6e} chain-steps/s)")
    hold(errs, "rwmh", f"{N_CHAINS} x {n_plain}", out_b500, ref_b500)

    kw = dict(burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_a, out_a = best_of(lambda: fused_rwmh_sample(*args, **kw))
    t_a_plain, ref_a = best_of(lambda: rwmh_sample_reference(*args, **kw), PLAIN_REPEATS)
    steps = N_WARM - 1 + N_DRAWS
    print(f"[{label}] rwmh_sample at {N_CHAINS} x ({N_WARM - 1} + {N_DRAWS}): kernel "
          f"{t_a * 1e3:.4f} ms ({N_CHAINS * steps / t_a:.6e} chain-steps/s), plain "
          f"{t_a_plain * 1e3:.4f} ms ({N_CHAINS * steps / t_a_plain:.6e} chain-steps/s)")
    hold(errs, "rwmh_sample", f"{N_CHAINS} x ({N_WARM - 1} + {N_DRAWS})", out_a, ref_a)
    del out_a, ref_a

    def run_sample():
        return sample(model, spl, N_DRAWS, num_chains=N_CHAINS, engine="fused",
                      discard_initial=N_WARM, initial_params=[0.0, 1.0],
                      key=KEY, chain_type="chains", param_names=["μ", "σ"])

    t_sample, chains = best_of(run_sample)
    ess_mu = float(ess_bulk(chains["μ"]))
    print(f"[{label}] sample(engine='fused') {N_CHAINS} chains x ({N_WARM} + {N_DRAWS}): "
          f"{t_sample:.4f} s (best of 3), ess_bulk(mu)={ess_mu:.1f}, "
          f"ESS/s(mu)={ess_mu / t_sample:.6e}")
    t_summary, _ = best_of(lambda: run_sample().summary())
    print(f"[{label}] sample(engine='fused') + Chains.summary(): {t_summary:.4f} s "
          f"(best of 3), ESS/s(mu) incl. summary={ess_mu / t_summary:.6e}")
    times["rwmh_sample"] = (t_a, t_a_plain, bound("rwmh_sample", C=N_CHAINS, steps=steps,
                                                    emitted=N_DRAWS))
    times["rwmh"] = (t_b500, t_b500_plain, bound("rwmh", C=N_CHAINS, steps=n_plain, emitted=0))


def cuda_ms(fn, n: int = 20) -> float:
    """Device ms a call of ``fn`` over ``n`` calls after one warm-up, by CUDA
    events (each call's inputs exceed the 50 MB L2, so none starts warm)."""
    fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / n


def bound_autocov(N: int, C: int, K: int):
    """(bound in seconds, "bytes" or "operations") of one lag-window launch:
    a multiply and an add for each draw and lag, one read of the draws and
    means, K float64 sums written."""
    return _bound(N * C * 4 + C * 4 + K * 8, 2.0 * N * C * K)


def truncation_lag(x: torch.Tensor):
    """The lag of the first pair that Geyer's running min leaves
    non-positive in the lag window of draws ``x`` (None: not in the window)."""
    from advancedmh_tpu_torch.diagnostics.ess import _geyer_tau, _window_rho

    rho = _window_rho(x)
    _, pair_sums = _geyer_tau(rho, rho.shape[0] // 2)
    cut = (pair_sums <= 0).nonzero()
    return None if cut.numel() == 0 else 2 * int(cut[0])


def phase_timing_autocov(model, label, errs, times):
    """The lag-window autocovariance kernel (no TPU counterpart) on each
    parameter's (N, C) view of the flagship's Chains.values (4000 x 2 x
    16384, row stride 2 C), beside its bound, its plain version and the FFT
    ESS it spares; and the window's ESS against the FFT's."""
    from advancedmh_tpu_torch import MvNormal, RWMH, sample
    from advancedmh_tpu_torch.diagnostics.ess import LAG_WINDOW, _ess_fft, _ess_window
    from advancedmh_tpu_torch.ops.autocov import autocov_window, autocov_window_reference

    spl = RWMH(MvNormal(torch.zeros(2, device=DEVICE), scale=SCALE))
    chains = sample(model, spl, N_DRAWS, num_chains=N_CHAINS, engine="fused",
                    discard_initial=N_WARM, initial_params=[0.0, 1.0], key=KEY,
                    chain_type="chains", param_names=["μ", "σ"])
    bound_s, bound_by = bound_autocov(N_DRAWS, N_CHAINS, LAG_WINDOW)
    worst = 0.0
    per_param = []
    for i, name in enumerate(chains.names):
        x = chains.values[:, i, :]
        check(x.stride() == (2 * N_CHAINS, 1), f"autocov: {name}'s view is not strided in place")
        m = torch.mean(x, dim=0)
        before = autocov_window.launches
        got = autocov_window(x, m, LAG_WINDOW)
        again = autocov_window(x, m, LAG_WINDOW)
        sync()
        check(autocov_window.launches == before + 2, "autocov: a CUDA view took the plain version")
        check(torch.equal(got, again), "autocov: two launches differ")
        t_plain, ref = best_of(lambda: autocov_window_reference(x, m, LAG_WINDOW), PLAIN_REPEATS)
        err = float((got - ref).abs().max() / ref[0])
        check(err <= 1e-5, f"autocov {name}: sums {err:.3e} of S_0 off the plain version")
        worst = max(worst, err)
        ms = cuda_ms(lambda: autocov_window(x, m, LAG_WINDOW))
        ms_mean = cuda_ms(lambda: torch.mean(x, dim=0))
        ms_window = cuda_ms(lambda: _ess_window(x))
        ms_fft = cuda_ms(lambda: _ess_fft(x), n=5)
        e_w, decided = _ess_window(x)
        e_f = _ess_fft(x)
        rel = abs(float(e_w) / float(e_f) - 1.0)
        lag = truncation_lag(x)
        print(f"[{label}] autocov_window {name} ({N_DRAWS} x {N_CHAINS}, row stride "
              f"{x.stride(0)}, K = {LAG_WINDOW}): kernel {ms:.4f} ms ({ms / (bound_s * 1e3):.2f}x "
              f"its bound {bound_s * 1e3:.4f} ms by {bound_by}, {bound_s * 1e3 / ms * 100:.1f}% of it), chain "
              f"means {ms_mean:.4f} ms, _ess_window {ms_window:.4f} ms, _ess_fft {ms_fft:.4f} ms, "
              f"plain {t_plain * 1e3:.2f} ms; sums within {err:.3e} of S_0; Geyer ends at lag "
              f"{lag}; decided {bool(decided)}; ESS window {float(e_w):.2f} FFT {float(e_f):.2f} "
              f"(rel {rel:.2e})")
        check(bool(decided), f"autocov {name}: the flagship's sequence runs past the window")
        check(rel <= 1e-5, f"autocov {name}: window ESS {rel:.2e} off the FFT's")
        per_param.append((ms, t_plain))
    before = autocov_window.launches
    chains.summary()
    sync()
    n_launches = autocov_window.launches - before
    check(n_launches == len(chains.names),
          f"autocov: summary() launched the window {n_launches} times for 2 parameters")
    errs["autocov"] = worst
    ms, t_plain = max(per_param)
    times["autocov"] = (ms / 1e3, t_plain, (bound_s, bound_by), n_launches)


def time_path(label, name, run, param):
    """sample(...) + Chains.summary(), best of 3, and ESS/s on ``param``."""
    from advancedmh_tpu_torch import ess_bulk

    torch.cuda.reset_peak_memory_stats()
    t_sample, chains = best_of(run)
    ess_p = float(ess_bulk(chains[param]))
    del chains  # the draws of a d = 64 path take 8.4 GB
    t_summary, _ = best_of(lambda: run().summary())
    print(f"[{label}] {name}: sample {t_sample:.4f} s, sample + Chains.summary() "
          f"{t_summary:.4f} s (best of 3), ess_bulk({param})={ess_p:.1f}, "
          f"ESS/s({param})={ess_p / t_sample:.6e}, incl. summary {ess_p / t_summary:.6e}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held after")


def phase_timing_new(models, label, errs, times):
    from advancedmh_tpu_torch import MALA, RobustAdaptiveMetropolis, sample
    from advancedmh_tpu_torch.ops import (RamParams, emcee_sample_reference,
                                          fused_emcee_sample, fused_mala_sample,
                                          fused_ram_sample, mala_sample_reference,
                                          ram_sample_reference)

    flag, demo = models["flagship"], models["emcee"]
    p0 = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, N_CHAINS).contiguous()
    steps = N_WARM - 1 + N_DRAWS

    args = mala_args(flag, p0, KEY)
    kw = dict(step_size_sq=MALA_S2, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_k, out = best_of(lambda: fused_mala_sample(*args, **kw))
    t_p, ref = best_of(lambda: mala_sample_reference(*args, **kw), PLAIN_REPEATS)
    print(f"[{label}] mala at {N_CHAINS} x ({N_WARM - 1} + {N_DRAWS}): kernel "
          f"{t_k * 1e3:.4f} ms ({N_CHAINS * steps / t_k:.6e} chain-steps/s), plain "
          f"{t_p * 1e3:.4f} ms ({N_CHAINS * steps / t_p:.6e} chain-steps/s)")
    hold(errs, "mala", f"{N_CHAINS} x ({N_WARM - 1} + {N_DRAWS})", out[:3], ref[:3])
    times["mala"] = (t_k, t_p, bound("mala", C=N_CHAINS, steps=steps, emitted=N_DRAWS))
    del out, ref

    args = ram_args(flag, p0, KEY)
    kw = dict(warmup=N_WARM, thin=1, n_samples=N_DRAWS, params=RamParams())
    t_k, out = best_of(lambda: fused_ram_sample(*args, **kw))
    t_p, ref = best_of(lambda: ram_sample_reference(*args, **kw), PLAIN_REPEATS)
    print(f"[{label}] ram at {N_CHAINS} x ({N_WARM} warmup + {N_DRAWS}): kernel "
          f"{t_k * 1e3:.4f} ms ({N_CHAINS * (N_WARM + N_DRAWS) / t_k:.6e} chain-steps/s), "
          f"plain {t_p * 1e3:.4f} ms ({N_CHAINS * (N_WARM + N_DRAWS) / t_p:.6e} chain-steps/s)")
    hold(errs, "ram", f"{N_CHAINS} x ({N_WARM} + {N_DRAWS})", out, ref)
    times["ram"] = (t_k, t_p, bound("ram", C=N_CHAINS, steps=N_DRAWS, emitted=N_DRAWS,
                                    warmup=N_WARM))
    del out, ref

    init, _ = emcee_sampler().init(torch.Generator(device=DEVICE).manual_seed(KEY), demo)
    x0 = init.params.T.contiguous()
    args = (demo.tile_density, demo.cuda_density, x0, demo.tile_density(x0), (), KEY)
    kw = dict(stretch_length=2.0, tile_walkers=N_CHAINS, burn=N_WARM - 1, thin=1,
              n_samples=N_DRAWS)
    t_k, out = best_of(lambda: fused_emcee_sample(*args, **kw))
    t_p, ref = best_of(lambda: emcee_sample_reference(*args, **kw), PLAIN_REPEATS)
    print(f"[{label}] emcee at {N_CHAINS} walkers x ({N_WARM - 1} + {N_DRAWS}): kernel "
          f"{t_k * 1e3:.4f} ms ({N_CHAINS * steps / t_k:.6e} walker-steps/s), plain "
          f"{t_p * 1e3:.4f} ms ({N_CHAINS * steps / t_p:.6e} walker-steps/s)")
    # Walkers read each other, so one flipped decision would spread through
    # the ensemble. The emcee model has no observation sum and kernel and
    # plain version evaluate it in one order, so the whole run is held to
    # 99.9% of equal decisions, its first 64 draws element-wise, and the
    # means and acceptance besides.
    means = [tuple(float(o[0][:, i].mean()) for i in range(2)) for o in (out, ref)]
    accs = [float(o[2].mean()) for o in (out, ref)]
    same = float((out[2] == ref[2]).float().mean())
    r = agreement(tuple(o[:64] for o in out), tuple(o[:64] for o in ref))
    print(f"emcee {N_CHAINS} x {steps} kernel vs plain: means {means[0]} / {means[1]}, "
          f"acceptance {accs[0]:.5f} / {accs[1]:.5f}, equal decisions {same:.6f}; "
          f"first 64 draws: {r}")
    check(same >= 0.999, f"emcee long run: decisions agree {same:.6f} < 0.999")
    check_agreement("emcee long run, first 64 draws", r, SHORT_RUN_CHAINS_MIN,
                    visible_steps=False)
    errs["emcee"] = max(errs["emcee"], r["max_abs_err"])
    check(all(abs(a - b) < 0.05 for a, b in zip(*means)), "emcee long run: means differ")
    check(abs(accs[0] - accs[1]) < 0.01, "emcee long run: acceptance differs")
    times["emcee"] = (t_k, t_p, bound("emcee", C=N_CHAINS, steps=steps, emitted=N_DRAWS))
    del out, ref

    time_path(label, f"mala sample(engine='fused') {N_CHAINS} x ({N_WARM} + {N_DRAWS})",
              lambda: sample(flag, MALA.langevin(MALA_S2), N_DRAWS, num_chains=N_CHAINS,
                             engine="fused", discard_initial=N_WARM, initial_params=[0.0, 1.0],
                             key=KEY + 10, chain_type="chains", param_names=["μ", "σ"]), "μ")
    for pooled in (False, True):
        time_path(label, f"ram{' pooled' if pooled else ''} sample(engine='fused') "
                  f"{N_CHAINS} x ({N_WARM} + {N_DRAWS})",
                  lambda: sample(flag, RobustAdaptiveMetropolis(pooled=pooled), N_DRAWS,
                                 num_chains=N_CHAINS, engine="fused", num_warmup=N_WARM,
                                 initial_params=[0.0, 1.0], key=KEY + 20,
                                 chain_type="chains", param_names=["μ", "σ"]), "μ")
    time_path(label, f"emcee sample(engine='fused') {N_CHAINS} walkers x ({N_WARM} + {N_DRAWS})",
              lambda: sample(demo, emcee_sampler(), N_DRAWS, engine="fused",
                             discard_initial=N_WARM, key=KEY + 30, chain_type="chains",
                             param_names=["s", "m"]), "m")


# ---- bounds ---------------------------------------------------------------------------

# float32 operations per chain-step, counted from the sources (csrc/*.cu)
# at d = 2: each add, multiply, divide, compare-select, sqrt, log, exp and
# sincos counts one; Philox's integer arithmetic is not counted. The noise
# of a step (one Box-Muller pair and the accept uniform) is 15; the
# flagship's density 5 n + 7 and its value and gradient 8 n + 15 over its
# n = 30 observations; the emcee model's density 18.
_N_OBS = 30
_FLOPS = {
    "rwmh": 15 + 4 + (5 * _N_OBS + 7) + 2,
    "mala": 15 + 4 * 2 + (8 * _N_OBS + 15) + 4 * 2 + 4 * 2 + 4 + 2,
    "ram": 15 + 6 + 2 + (5 * _N_OBS + 7) + 5,
    "ram_warmup": 15 + 6 + 2 + (5 * _N_OBS + 7) + 5 + (3 * 4 + 16 * 2 + 15),
    "emcee": 6 + 3 + 4 + 3 * 2 + 18 + 4 + 2,
}


# Slice 3, counted the same way from csrc/common.cuh, csrc/hmc_group.cuh,
# csrc/hmc_adapt.cu and csrc/adapt.cu. The noise of a step is 12 per
# Box-Muller pair plus 3 (15 at d = 2, as above). The logistic regression's
# value and gradient at d coefficients and n observations: per observation
# the logit's 2d - 1, nine for the likelihood term (abs, exp, max, log1p and
# the adds), seven for softplus' and 2d for the gradient sums; per
# evaluation 4d + 8 (the partials, b.b, the prior). An HMC step: the noise,
# 8d for the momentum and both kinetic energies, per leapfrog 7d plus a
# value and gradient, 6 for the accept; a warmup step of the adaptive kernel
# adds 13d + 16 (M^-1 from M2, dual averaging, Welford). Dual-averaging
# RWMH on the flagship: an RWMH step with the isotropic ε (2d), plus 16 in
# warmup.


def _noise_ops(d: int) -> int:
    return 12 * ((d + 1) // 2) + 3


def logreg_vg_ops(d: int, n: int) -> int:
    return n * ((2 * d - 1) + 9 + 7 + 2 * d) + 4 * d + 8


def bound_hmc(C: int, steps: int, emitted: int, warmup: int, d: int, n_obs: int):
    """(bound in seconds, "bytes" or "operations") of one HMC or AdaptiveHMC
    launch on the logistic regression with N_LEAPFROG leapfrog steps."""
    step = (_noise_ops(d) + 8 * d + N_LEAPFROG * (7 * d + logreg_vg_ops(d, n_obs)) + 6)
    flops = (step * steps + (13 * d + 16) * warmup) * C
    # in: x, lp, gradient and the constants; out: the draws, the final
    # gradient and, adaptive, the frozen log ε̄ and M⁻¹
    nbytes = ((2 * d + 1) * C + n_obs * (d + 1) + 1 + emitted * (d + 2) * C + d * C
              + (d + 1) * C * (warmup > 0)) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Slice 4, counted the same way from csrc/chees.cu and csrc/meads.cu. A ChEES
# trajectory of L leapfrog steps is an HMC step (above) with L trips; a
# warmup step adds, per chain, the acceptance probability and the healthy
# test (2d + 4), the two rounds' values (4d + 3) and the ChEES pieces
# (8d + 6), 14d + 13 in all (the tile's scalar update is shared). A MEADS
# chain-step: the noise, the GHMC move (11d + 14 and one value and
# gradient), and its share of the fold statistics as a member of the
# complementary fold: mu and sigma (3d), sigma g and (x - mu)/sigma with
# their column norms (6d) and the two Gram matrices (2 d^2 multiply-adds,
# 4 d^2 operations).


def bound_chees(C: int, trips, emitted: int, warmup: bool, d: int = 32, n_obs: int = 256):
    """(bound in seconds, "bytes" or "operations") of a ChEES launch on the
    logistic regression whose steps run ``trips`` leapfrog steps each."""
    per_traj = _noise_ops(d) + 8 * d + 6 + (14 * d + 13) * warmup
    flops = (len(trips) * per_traj + sum(trips) * (7 * d + logreg_vg_ops(d, n_obs))) * C
    # in: x, lp, gradient and the constants; out: the draws (frozen) or the
    # final state and decisions (warmup), and the final gradient
    nbytes = ((2 * d + 1) * C + n_obs * (d + 1) + 1 + emitted * (d + 2) * C + d * C
              + (d + 2) * C * warmup) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_meads(C: int, steps: int, emitted: int, d: int = 32, n_obs: int = 256):
    """(bound in seconds, "bytes" or "operations") of one MEADS launch on the
    logistic regression."""
    step = _noise_ops(d) + 11 * d + 14 + logreg_vg_ops(d, n_obs) + 9 * d + 4 * d * d
    nbytes = ((4 * d + 2) * C * 2 + n_obs * (d + 1) + 1 + emitted * (d + 2) * C) * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, step * steps * C / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(name: str, C: int, steps: int, emitted: int, warmup: int = 0, d: int = 2):
    """(bound in seconds, "bytes" or "operations") of one launch: each input
    read once and each output written once over 3.35 TB/s, and the float32
    operations over 67 TFLOP/s; the larger sets the bound."""
    state_in = (d + 1) * C * 4  # params + lp
    emit = emitted * (d + 2) * C * 4  # samples, lps, accepted
    consts = _N_OBS * 4
    if name == "rwmh_sample":
        nbytes, flops = state_in + consts + emit, _FLOPS["rwmh"] * C * steps
    elif name == "rwmh":
        nbytes, flops = state_in + consts + (d + 2) * C * 4, _FLOPS["rwmh"] * C * steps
    elif name == "mala":  # + the gradient in and out
        nbytes = state_in + consts + emit + 2 * d * C * 4
        flops = _FLOPS["mala"] * C * steps
    elif name == "ram":  # + S in and out
        nbytes = state_in + consts + emit + 2 * d * d * C * 4
        flops = (_FLOPS["ram_warmup"] * warmup + _FLOPS["ram"] * steps) * C
    elif name == "adapt_rwmh":  # + the frozen log ε̄ out
        nbytes = state_in + consts + emit + C * 4
        flops = ((_FLOPS["rwmh"] + 16) * warmup + _FLOPS["rwmh"] * steps) * C
    else:  # emcee: one half-move per walker and step
        nbytes = state_in + emit
        flops = _FLOPS["emcee"] * C * steps
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- main -------------------------------------------------------------------------------


def launch_report(models, gps, ptxas_lines) -> None:
    """The launch shapes of the kernels redesigned for the card (MEADS: a
    cluster per tile; AdaptiveHMC, HMC, ChEES's frozen phase, Barker and
    the evidence kernel: a group of chains a block; ESS and pCN: 8 lanes a
    chain on the GP likelihoods; RWMH: the flagship's lanes a chain) at the
    main paths' widths, with their occupancy and ptxas' registers and
    spills. Fails if a group kernel of a fresh build spills on the logistic
    regression, an ESS or pCN kernel on any of its pairs, or an RWMH kernel
    in the flagship's group form with a per-dimension scale."""
    from advancedmh_tpu_torch.ops.barker import barker_launch_info
    from advancedmh_tpu_torch.ops.chees import chees_frozen_launch_info
    from advancedmh_tpu_torch.ops.ess import ess_launch_info
    from advancedmh_tpu_torch.ops.evidence import evidence_launch_info
    from advancedmh_tpu_torch.ops.hmc import hmc_launch_info
    from advancedmh_tpu_torch.ops.hmc_adapt import adaptive_hmc_launch_info
    from advancedmh_tpu_torch.ops.meads import meads_launch_info
    from advancedmh_tpu_torch.ops.pcn import pcn_launch_info
    from advancedmh_tpu_torch.ops._build import flat_consts
    from advancedmh_tpu_torch.ops.rwmh import rwmh_launch_info
    from advancedmh_tpu_torch.runtime.fused import MAX_TILE, MEADS_BUDGET, fused_tile

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    m = models["flagship"]
    n_consts = flat_consts(m.tile_consts, DEVICE)[1]
    for tril in (False, True):
        info = rwmh_launch_info(m.cuda_density, 2, tril, n_consts, N_CHAINS)
        launched = info["blocks"] * info["threads"] / 32 / n_sm
        print(f"launch rwmh_sample gaussian_mean_scale d=2 tril={tril} C={N_CHAINS}: {info}; "
              f"warps launched per SM {launched:.2f} on {n_sm} SMs")
        check(info["lanes_per_chain"] > 1 and info["smem_bytes"] == 0,
              "rwmh: the flagship does not run its group form")
    for key, C in (("logreg", LOGREG_CHAINS), ("logreg", MEADS_WIDE_CHAINS),
                   ("funnel", LOGREG_CHAINS), ("corr", LOGREG_CHAINS)):
        m = models[key]
        d = m.dimension
        n_consts = flat_consts(m.tile_consts, DEVICE)[1]
        tile = fused_tile(C, MAX_TILE, d, MEADS_BUDGET)
        info = meads_launch_info(m.cuda_density, d, n_consts, C, 2, tile)
        print(f"launch meads {m.cuda_density} d={d} C={C} tile={tile} K=2: {info}")
        check(info["active_clusters"] >= 1, "meads: the card holds no cluster of this launch")
    m = models["logreg"]
    n_consts = flat_consts(m.tile_consts, DEVICE)[1]
    group = {"adaptive_hmc": adaptive_hmc_launch_info, "hmc_sample": hmc_launch_info,
             "chees_frozen": chees_frozen_launch_info, "barker_sample": barker_launch_info}
    for name, launch_info in group.items():
        info = launch_info(m.cuda_density, 32, n_consts, LOGREG_CHAINS)
        launched = info["blocks"] * info["threads"] / 32 / n_sm
        print(f"launch {name} logistic_regression d=32 C={LOGREG_CHAINS}: {info}; warps "
              f"launched per SM {launched:.2f} on {n_sm} SMs")
        check(info["chains_per_block"] == 16 and info["threads"] == 128,
              f"{name}: the logistic regression does not run 16 chains of 8 lanes a block")
    m = models["logreg_lik"]
    n_consts = flat_consts(m.tile_consts, DEVICE)[1]
    for adapt in (True, False):
        info = evidence_launch_info(m.cuda_density, 32, adapt, n_consts, 16 * EV_CHAINS)
        launched = info["blocks"] * info["threads"] / 32 / n_sm
        print(f"launch power_rwmh logistic_regression d=32 adapt={adapt} C={16 * EV_CHAINS}: "
              f"{info}; warps launched per SM {launched:.2f} on {n_sm} SMs")
        check(info["chains_per_block"] == 16 and info["lanes_per_chain"] == 8
              and info["blocks_per_sm"] >= 4,
              "evidence: the logistic regression does not run 16 chains of 8 lanes a block, "
              "4 an SM")
    for key in ("class64", "reg64"):
        m = gps[key][0]
        n_consts = flat_consts(m.tile_consts, DEVICE)[1]
        for name, launch_info in (("ess_sample", ess_launch_info),
                                  ("pcn_sample", pcn_launch_info)):
            for tril in (True, False):
                info = launch_info(m.cuda_density, 64, tril, n_consts, GP_CHAINS)
                launched = info["blocks"] * info["threads"] / 32 / n_sm
                print(f"launch {name} {m.cuda_density} d=64 tril={tril} C={GP_CHAINS}: "
                      f"{info}; warps launched per SM {launched:.2f} on {n_sm} SMs")
                check(info["chains_per_block"] == 16 and info["lanes_per_chain"] == 8
                      and info["blocks_per_sm"] >= 4,
                      f"{name}: {m.cuda_density} does not run 16 chains of 8 lanes a block, "
                      f"4 an SM")
    if not ptxas_lines:
        print("  ptxas: the library was built before this run; no register report")
        return
    for kernel in ("meads", *group, "power_rwmh"):
        lines = [ln for ln in ptxas_lines
                 if ln.startswith(f"{kernel}_kernel<LogisticRegression<32>")]
        check(bool(lines), f"ptxas reported no {kernel}_kernel on the logistic regression")
        for line in lines:
            print(f"  ptxas (redesigned): {line}")
            check(kernel == "meads" or " 0 bytes spill stores" in line,
                  f"{kernel}_kernel on the logistic regression spills")
    for kernel in ("ess_sample", "pcn_sample"):
        lines = [ln for ln in ptxas_lines if ln.startswith(f"{kernel}_kernel<")]
        check(len(lines) == 8, f"ptxas reported {len(lines)} of {kernel}'s 8 kernels")
        for line in lines:
            print(f"  ptxas (redesigned): {line}")
            check(" 0 bytes spill stores" in line, f"{line.split(':')[0]} spills")
    lines = [ln for ln in ptxas_lines
             if ln.startswith(("rwmh_sample_kernel<GaussianMeanScale,",
                               "rwmh_kernel<GaussianMeanScale,"))
             and ln.split(":")[0].endswith(", true>")]
    check(len(lines) == 4, f"ptxas reported {len(lines)} of the flagship's 4 group RWMH kernels")
    for line in lines:
        print(f"  ptxas (redesigned): {line}")
        # the main path's scale is per dimension (tril false); a full factor
        # is reported, not gated
        if ", false, true>" in line:
            check(" 0 bytes spill stores" in line, f"{line.split(':')[0]} spills")


def ptxas_summary(report: str):
    """One line per compiled kernel of nvcc's -Xptxas -v report: its name,
    density and flags (from the mangled name), registers and spills."""
    import re

    out, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(_ZN3amh\d+(\w+?)I\w*)'", line)
        if m:
            mangled = m.group(1)
            dens = re.findall(r"(GaussianMeanScale|EmceeDemo|CorrelatedGaussianILi\d+E"
                              r"|LogisticRegressionILi\d+E|NealFunnelILi\d+E"
                              r"|GPRegressionILi\d+E|GPClassificationILi\d+E|Banana"
                              r"|BimodalMixture|NormalMean|FlatILi\d+E)", mangled)
            flags = re.findall(r"Lb([01])E", mangled)
            kernel = re.match(r"_ZN3amh\d+([a-z_]+)", mangled).group(1)
            density = re.sub(r"ILi(\d+)E", r"<\1>", dens[0]) if dens else "?"
            flags = "".join(f", {'true' if f == '1' else 'false'}" for f in flags)
            name = f"{kernel}<{density}{flags}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
            name, spill = None, ""
    return out


REPLACES = {
    "rwmh_sample": ("advancedmh_tpu/ops/pallas_mh.py:238", "rwmh.cu"),
    "rwmh": ("advancedmh_tpu/ops/pallas_mh.py:104", "rwmh.cu"),
    "mala": ("advancedmh_tpu/ops/pallas_mala.py:30", "mala.cu"),
    "ram": ("advancedmh_tpu/ops/pallas_ram.py:36", "ram.cu"),
    "emcee": ("advancedmh_tpu/ops/pallas_emcee.py:33", "emcee.cu"),
    "adapt_rwmh": ("advancedmh_tpu/ops/pallas_adapt.py:30", "adapt.cu"),
    "hmc": ("advancedmh_tpu/ops/pallas_hmc.py:32", "hmc.cu"),
    "adaptive_hmc": ("advancedmh_tpu/ops/pallas_hmc_adapt.py:37", "hmc_adapt.cu"),
    "chees_warmup": ("advancedmh_tpu/ops/pallas_chees.py:306", "chees.cu"),
    "chees_frozen": ("advancedmh_tpu/ops/pallas_chees.py:73", "chees.cu"),
    "meads": ("advancedmh_tpu/ops/pallas_meads.py:68", "meads.cu"),
    "slice": ("advancedmh_tpu/ops/pallas_slice.py:35", "slice.cu"),
    "ess": ("advancedmh_tpu/ops/pallas_ess.py:51", "ess.cu"),
    "barker": ("advancedmh_tpu/ops/pallas_barker.py:36", "barker.cu"),
    "pcn": ("advancedmh_tpu/ops/pallas_pcn.py:27", "pcn.cu"),
    "am": ("advancedmh_tpu/ops/pallas_am.py:90", "am.cu"),
    "dram": ("advancedmh_tpu/ops/pallas_dram.py:29", "dram.cu"),
    "dr": ("advancedmh_tpu/ops/pallas_dr.py:46", "dr.cu"),
    "mtm_sample": ("advancedmh_tpu/ops/pallas_mtm.py:205", "mtm.cu"),
    "mtm": ("advancedmh_tpu/ops/pallas_mtm.py:107", "mtm.cu"),
    "tempering": ("advancedmh_tpu/ops/pallas_tempering.py:37", "tempering.cu"),
    "demc": ("advancedmh_tpu/ops/pallas_demc.py:37", "demc.cu"),
    "evidence": ("advancedmh_tpu/ops/pallas_evidence.py:41", "evidence.cu"),
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from advancedmh_tpu_torch.models import (correlated_gaussian_model,
                                                 emcee_demo_model,
                                                 gaussian_mean_scale_model,
                                                 banana_model,
                                                 bimodal_mixture_model,
                                                 flat_likelihood,
                                                 logistic_regression_model,
                                                 neal_funnel_model,
                                                 normal_mean_likelihood)
        from advancedmh_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"advancedmh_tpu_torch is not importable next to this script: {e}")

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    label = card
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    path, build_s, report = _build.build()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    sources = [line for line in report.splitlines() if line.startswith("amh build:")]
    slowest = max(sources, key=lambda line: float(line.split()[-2]), default=None)
    print(f"build: {path.name} in {build_s:.2f} s ({nvcc[-1] if nvcc else 'nvcc'}); slowest "
          f"source: {slowest.split(': ')[1] if slowest else 'none (built before this run)'}")
    for line in sources:
        print(f"  {line}")
    ptxas_lines = ptxas_summary(report)
    for line in ptxas_lines:
        print(f"  ptxas: {line}")
    lib = _build.library()
    for kernel in _build.KERNELS:
        print(f"registry {kernel}: {sorted(_build.kernel_pairs(lib, kernel))}")

    models = {
        "flagship": gaussian_mean_scale_model(device=DEVICE),
        "corr": correlated_gaussian_model([[1.5, 0.35], [0.35, 1.0]], device=DEVICE),
        "corr_ram": correlated_gaussian_model([[1.0, 0.5], [0.5, 1.0]], device=DEVICE),
        "corr4": correlated_gaussian_model(0.5 * np.ones((4, 4)) + 0.5 * np.eye(4),
                                           device=DEVICE),
        "emcee": emcee_demo_model(device=DEVICE),
        "logreg": logistic_regression_model(256, 32, seed=0, device=DEVICE),
        "aniso": correlated_gaussian_model(np.diag([25.0, 1.0]), device=DEVICE),
        "diag9": correlated_gaussian_model(np.diag([9.0, 1.0]), device=DEVICE),
        "funnel": neal_funnel_model(10, device=DEVICE),
        "corr8": correlated_gaussian_model(0.5 * np.ones((8, 8)) + 0.5 * np.eye(8),
                                           device=DEVICE),
        "banana": banana_model(device=DEVICE),
        "flag300": gaussian_mean_scale_model(n_obs=300, device=DEVICE),
        "bimodal": bimodal_mixture_model(device=DEVICE),
        "conj": normal_mean_likelihood(Y_CONJ, 1.0, device=DEVICE),
        "flat2": flat_likelihood(2, device=DEVICE),
        "logreg_lik": logistic_regression_model(256, 32, seed=0, prior_scale=float("inf"),
                                                device=DEVICE),
    }
    gps = gp_models()
    launch_report(models, gps, ptxas_lines)
    errs = {name: 0.0 for name in REPLACES}
    evals = {}
    phase_kernels_rwmh(models["flagship"], errs)
    phase_kernels_new(models, errs)
    phase_kernels_slice3(models, errs)
    phase_kernels_slice4(models, errs)
    phase_kernels_slice5(models, gps, errs, evals)
    phase_kernels_slice6(models, errs)
    phase_kernels_slice7(models, errs)
    phase_kernels_slice8(models, errs)
    print(f"kernel phase done at {time.perf_counter() - t_start:.1f} s")

    launches = {}
    spl, p0, lp0 = phase_main_rwmh(models["flagship"], label, launches)
    phase_main_mala(models["flagship"], label, launches)
    phase_main_ram(models["flagship"], label, launches)
    phase_main_emcee(models["emcee"], label, launches)
    phase_correlated(models)
    med_eps, minv_med, ref_summary = phase_main_logreg(models["logreg"], label, launches)
    phase_main_adapt(models["flagship"], label, launches)
    phase_slice3_checks(models)
    phase_main_chees_meads(models, label, launches, ref_summary)
    phase_slice4_checks(models)
    barker_eps = phase_main_slice5(models, gps, label, launches, ref_summary)
    phase_slice5_checks(models, gps)
    phase_main_slice6(models, label, launches)
    phase_slice6_checks(models)
    phase_main_slice7(models, label, launches)
    phase_slice7_checks(models)
    phase_main_slice8(models, label, launches)
    phase_slice8_checks(models)
    print(f"main paths done at {time.perf_counter() - t_start:.1f} s")

    times = {}
    phase_timing_rwmh(models["flagship"], spl, p0, lp0, label, errs, times)
    phase_timing_new(models, label, errs, times)
    phase_timing_slice3(models, label, errs, times, med_eps, minv_med)
    phase_timing_slice4(models, label, errs, times)
    phase_timing_slice5(models, gps, label, errs, times, evals, barker_eps)
    phase_timing_slice6(models, label, errs, times)
    phase_timing_slice7(models, label, errs, times)
    phase_timing_slice8(models, label, errs, times)
    phase_timing_autocov(models["flagship"], label, errs, times)
    print(f"[{label}] chip_smoke wall time {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, (replaces, source) in REPLACES.items():
        ms, plain_s, (bound_s, bound_by) = times[name][:3]
        kernels.append({
            "name": name, "route": "cuda", "source": f"advancedmh_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms * 1e3, "plain_ms": plain_s * 1e3, "bound_ms": bound_s * 1e3,
            "bound_by": bound_by, "library_ms": None,
        })
    ms, plain_s, (bound_s, bound_by), n_launches = times["autocov"]
    kernels.append({
        "name": "autocov", "route": "cuda", "source": "advancedmh_tpu_torch/csrc/autocov.cu",
        "replaces": None, "launches": n_launches, "max_abs_err": errs["autocov"],
        "ms": ms * 1e3, "plain_ms": plain_s * 1e3, "bound_ms": bound_s * 1e3,
        "bound_by": bound_by, "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
