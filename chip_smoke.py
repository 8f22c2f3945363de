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
dual-averaging RWMH (``StepSizeAdaptation.rwmh``) on the flagship, and slice 4:
ChEES-HMC and MEADS on the logistic regression at 8192 chains and MEADS on
Neal's funnel (d = 10). Each path runs
with every launch counter set to 0 just before it and read just after. The
posteriors are checked against a float64 grid quadrature (the flagship),
the analytic means (emcee), the ``engine="torch"`` run and the
correlated-Gaussian checks of the JAX package's tests. Then it times each
kernel at its main path's shape against its plain version, and the whole
call with ESS/s. The timed kernel outputs are held against the plain
versions' (emcee: its decisions over the whole run, its first 64 draws
element-wise, and its means). Every phase that fails exits non-zero. The last
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
    from advancedmh_tpu_torch.ops import fused_rwmh

    spl = RWMH(MvNormal(torch.zeros(2, device=DEVICE), scale=SCALE))
    p0 = torch.tensor([[0.0], [1.0]], device=DEVICE).expand(2, N_CHAINS).contiguous()
    lp0 = model.tile_density(p0, *model.tile_consts)

    reset_launches()
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
    from advancedmh_tpu_torch import MEADS, ChEESHMC, sample
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
        kw = dict(key=9 if C == 4096 else 17, num_chains=C, initial_params=zeros,
                  num_warmup=400, discard_initial=400, thinning=1)
        tr_f, st_f = sample_fused_chees(corr, spl, 600, warmup_engine="fused", **kw)
        tr_t, st_t = sample_fused_chees(corr, spl, 600, warmup_engine="torch", **kw)
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
                                600, key=3, num_chains=4096, initial_params=zeros,
                                num_warmup=500, discard_initial=500, thinning=1,
                                stage_clock=clock)
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
    from advancedmh_tpu_torch import MEADS, ChEESHMC
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
    tr, st = sample_fused_chees(lr, spl, N_DRAWS, key=KEY + 70, num_chains=C,
                                initial_params=torch.zeros(32, device=DEVICE),
                                num_warmup=N_WARM, discard_initial=N_WARM, thinning=1,
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


def time_path(label, name, run, param):
    """sample(...) + Chains.summary(), best of 3, and ESS/s on ``param``."""
    from advancedmh_tpu_torch import ess_bulk

    t_sample, chains = best_of(run)
    ess_p = float(ess_bulk(chains[param]))
    t_summary, _ = best_of(lambda: run().summary())
    print(f"[{label}] {name}: sample {t_sample:.4f} s, sample + Chains.summary() "
          f"{t_summary:.4f} s (best of 3), ess_bulk({param})={ess_p:.1f}, "
          f"ESS/s({param})={ess_p / t_sample:.6e}, incl. summary {ess_p / t_summary:.6e}")


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


# Slice 3, counted the same way from csrc/common.cuh, csrc/hmc.cuh,
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
                              r"|LogisticRegressionILi\d+E|NealFunnelILi\d+E)", mangled)
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
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from advancedmh_tpu_torch.models import (correlated_gaussian_model,
                                                 emcee_demo_model,
                                                 gaussian_mean_scale_model,
                                                 logistic_regression_model,
                                                 neal_funnel_model)
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
    print(f"build: {path.name} in {build_s:.2f} s ({nvcc[-1] if nvcc else 'nvcc'})")
    for line in ptxas_summary(report):
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
    }
    errs = {name: 0.0 for name in REPLACES}
    phase_kernels_rwmh(models["flagship"], errs)
    phase_kernels_new(models, errs)
    phase_kernels_slice3(models, errs)
    phase_kernels_slice4(models, errs)
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
    print(f"main paths done at {time.perf_counter() - t_start:.1f} s")

    times = {}
    phase_timing_rwmh(models["flagship"], spl, p0, lp0, label, errs, times)
    phase_timing_new(models, label, errs, times)
    phase_timing_slice3(models, label, errs, times, med_eps, minv_med)
    phase_timing_slice4(models, label, errs, times)
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
