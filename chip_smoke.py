#!/usr/bin/env python3
"""Smoke run of advancedmh_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``advancedmh_tpu_torch/csrc/`` (nvcc, at first
use), checks each kernel against its plain PyTorch version on the card,
drives the RWMH main path at full size through the public entry points
(``sample(engine="fused")`` + ``Chains.summary()``, and the ``fused_rwmh``
throughput kernel), checks the posterior against a float64 grid quadrature
and the ``engine="torch"`` run, and times kernels, plain versions and the
whole call. The timed kernel outputs at the main path's shapes are held
against the plain versions' too. Every phase that fails exits non-zero. The last line of stdout
is one JSON object: ``{"ok": true, "device": {...}}``; the line before it
lists the kernels with their launch counts, errors and times.

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

N_CHAINS = 16384  # bench.py's ESS harness (16384 chains, 500 + 4000)
N_WARM = 500
N_DRAWS = 4000
N_STEPS_THROUGHPUT = 10_000  # bench.py's headline kernel run
SCALE = 0.35  # bench.py's hand-swept RWMH scale
KEY = 2024


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def best_of(fn, repeats: int = 3):
    """Best wall time in seconds of ``fn()``, fenced by synchronize, and the
    result of the last call."""
    best, out = float("inf"), None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
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


# ---- phase 3: kernel against plain version ---------------------------------


def _start(C: int, seed: int):
    """Per-chain starts: μ ~ N(0, 1), σ ~ U(-0.5, 2), so some chains start
    outside the support (lp = -inf)."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.normal(size=C), rng.uniform(-0.5, 2.0, size=C)])
    return torch.tensor(p, dtype=torch.float32, device="cuda")


def _close(a, b):
    """States and lp: |a - b| <= 1e-5 + 1e-5·|b| (inf equal to inf)."""
    return torch.isclose(a, b, rtol=1e-5, atol=1e-5)


def _max_err(got, ref, ok):
    """Largest |got - ref| over the finite entries of the chains in ``ok``."""
    sel = ok.expand_as(got) & torch.isfinite(ref)
    return float((got - ref).abs()[sel].max()) if bool(sel.any()) else 0.0


def agreement(got, ref):
    """A kernel's outputs against its plain version's, chains on the last axis.

    ``got`` and ``ref`` are (states, lp, accepted) of kernel A, with
    accepted (N, 1, C) holding each emitted step's decision, or of kernel B,
    with accepted (1, C) holding accept counts. A chain is ok when all its
    decisions (or its count) agree and its states and lp are within
    ``_close``; ``max_abs_err`` is over the states and lp of the ok chains."""
    (s, l, a), (s_r, l_r, a_r) = got, ref
    check(s.shape == s_r.shape and l.shape == l_r.shape and a.shape == a_r.shape,
          "kernel and plain output shapes differ")
    dec_equal = (a == a_r).reshape(-1, a.shape[-1])  # (decisions, C)
    same_decisions = dec_equal.all(dim=0)
    lead = tuple(range(s.ndim - 1))
    close = _close(s, s_r).all(dim=lead) & _close(l, l_r).all(dim=lead)
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
    """The stated tolerance: >= 99.9% of (chain, step) decisions agree (kernel
    A) and at least ``chains_min`` of the chains agree in every output; with
    every step visible, no chain whose decisions all agree may differ in
    state or lp beyond ``_close``."""
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


def phase_kernels(model):
    diag = torch.tensor([SCALE, SCALE], device="cuda")
    tril = torch.tensor([[0.35, 0.0], [0.1, 0.3]], device="cuda")
    errs = {"rwmh_sample": 0.0, "rwmh": 0.0}
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
    torch.cuda.synchronize()
    return errs


# ---- phase 4: the main path ---------------------------------------------------


def phase_main_path(model, label):
    from advancedmh_tpu_torch import MvNormal, RWMH, ess_bulk, sample
    from advancedmh_tpu_torch.ops import fused_rwmh, fused_rwmh_sample

    spl = RWMH(MvNormal(torch.zeros(2, device="cuda"), scale=SCALE))
    p0 = torch.tensor([[0.0], [1.0]], device="cuda").expand(2, N_CHAINS).contiguous()
    lp0 = model.tile_density(p0, *model.tile_consts)

    fused_rwmh_sample.launches = 0
    fused_rwmh.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = sample(model, spl, N_DRAWS, num_chains=N_CHAINS, engine="fused",
                    discard_initial=N_WARM, initial_params=[0.0, 1.0], key=KEY)
    chains = result.to_chains(param_names=["μ", "σ"])
    summary = chains.summary()
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    _, _, acc_b = fused_rwmh(model.tile_density, model.cuda_density, p0, lp0, SCALE,
                             model.tile_consts, KEY, n_steps=N_STEPS_THROUGHPUT)
    torch.cuda.synchronize()
    launches = {"rwmh_sample": fused_rwmh_sample.launches, "rwmh": fused_rwmh.launches}
    print(f"main path launches: {launches}")
    check(launches == {"rwmh_sample": 1, "rwmh": 1}, f"main path launches {launches}")

    check(chains.values.shape == (N_DRAWS, 2, N_CHAINS), "Chains shape")
    check(bool(torch.isfinite(chains.values).all()), "non-finite draws")
    mu_q, sig_q = grid_posterior_means(model.tile_consts[0].cpu().numpy().ravel())
    acc = float(result.transitions.accepted.float().mean())
    acc_b_rate = float(acc_b.mean()) / N_STEPS_THROUGHPUT
    print(f"summary: {json.dumps(summary)}")
    print(f"grid quadrature means: mu={mu_q:.6f} sigma={sig_q:.6f}; "
          f"acceptance {acc:.4f} (fused_rwmh {acc_b_rate:.4f})")
    check(abs(summary["μ"]["mean"] - mu_q) < 0.01, "μ mean vs quadrature")
    check(abs(summary["σ"]["mean"] - sig_q) < 0.01, "σ mean vs quadrature")
    check(summary["μ"]["rhat"] < 1.01 and summary["σ"]["rhat"] < 1.01, "R-hat >= 1.01")
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
    return spl, p0, lp0, launches


# ---- phase 5: timing -----------------------------------------------------------


def phase_timing(model, spl, p0, lp0, label):
    from advancedmh_tpu_torch import ess_bulk, sample
    from advancedmh_tpu_torch.ops import (fused_rwmh, fused_rwmh_sample,
                                          rwmh_reference, rwmh_sample_reference)

    args = (model.tile_density, model.cuda_density, p0, lp0, SCALE, model.tile_consts, KEY)
    errs = {}

    def hold(name, tag, got, ref):
        """The timed outputs at the main path's shapes against the plain
        version's, with the long-run tolerance."""
        r = agreement(got, ref)
        print(f"kernel {name} {tag}: {r}")
        check_agreement(f"{name} {tag}", r, LONG_RUN_CHAINS_MIN, visible_steps=False)
        errs[name] = max(errs.get(name, 0.0), r["max_abs_err"])

    t_b, out_b = best_of(lambda: fused_rwmh(*args, n_steps=N_STEPS_THROUGHPUT))
    rate_b = N_CHAINS * N_STEPS_THROUGHPUT / t_b
    print(f"[{label}] rwmh kernel: {rate_b:.6e} chain-steps/s "
          f"({N_CHAINS} x {N_STEPS_THROUGHPUT}, {t_b * 1e3:.4f} ms, best of 3)")
    hold("rwmh", f"{N_CHAINS} x {N_STEPS_THROUGHPUT}", out_b,
         rwmh_reference(*args, n_steps=N_STEPS_THROUGHPUT))
    n_plain = 500
    t_b500, out_b500 = best_of(lambda: fused_rwmh(*args, n_steps=n_plain))
    t_b500_plain, ref_b500 = best_of(lambda: rwmh_reference(*args, n_steps=n_plain))
    print(f"[{label}] rwmh at {N_CHAINS} x {n_plain}: kernel {t_b500 * 1e3:.4f} ms "
          f"({N_CHAINS * n_plain / t_b500:.6e} chain-steps/s), plain "
          f"{t_b500_plain * 1e3:.4f} ms ({N_CHAINS * n_plain / t_b500_plain:.6e} chain-steps/s)")
    hold("rwmh", f"{N_CHAINS} x {n_plain}", out_b500, ref_b500)

    kw = dict(burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    t_a, out_a = best_of(lambda: fused_rwmh_sample(*args, **kw))
    t_a_plain, ref_a = best_of(lambda: rwmh_sample_reference(*args, **kw))
    steps = N_WARM - 1 + N_DRAWS
    print(f"[{label}] rwmh_sample at {N_CHAINS} x ({N_WARM - 1} + {N_DRAWS}): kernel "
          f"{t_a * 1e3:.4f} ms ({N_CHAINS * steps / t_a:.6e} chain-steps/s), plain "
          f"{t_a_plain * 1e3:.4f} ms ({N_CHAINS * steps / t_a_plain:.6e} chain-steps/s)")
    hold("rwmh_sample", f"{N_CHAINS} x ({N_WARM - 1} + {N_DRAWS})", out_a, ref_a)
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
    times = {"rwmh_sample": (t_a, t_a_plain), "rwmh": (t_b500, t_b500_plain)}
    return times, errs


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script runs only on a CUDA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from advancedmh_tpu_torch.models import gaussian_mean_scale_model
        from advancedmh_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"advancedmh_tpu_torch is not importable next to this script: {e}")

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
    print(f"build: {path.name} in {build_s:.2f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    model = gaussian_mean_scale_model(device="cuda")
    errs = phase_kernels(model)
    spl, p0, lp0, launches = phase_main_path(model, label)
    times, errs_main = phase_timing(model, spl, p0, lp0, label)
    errs = {name: max(errs[name], errs_main[name]) for name in errs}

    replaces = {"rwmh_sample": "advancedmh_tpu/ops/pallas_mh.py:238",
                "rwmh": "advancedmh_tpu/ops/pallas_mh.py:104"}
    kernels = [
        {"name": name, "route": "cuda", "source": "advancedmh_tpu_torch/csrc/rwmh.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0] * 1e3,
         "plain_ms": times[name][1] * 1e3}
        for name in ("rwmh_sample", "rwmh")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
