#!/usr/bin/env python3
"""Time the hand-written kernels of two checkouts of this repository on one
GPU, in turns: A, B, B, A.

    git archive <parent commit> | tar -x -C _archive/parent
    python3 tools/kernel_ab.py --a _archive/parent --b .

Each turn is a fresh process that imports ``advancedmh_tpu_torch`` from its
checkout (building its kernels there at first use) and times, best of 3 and
CUDA-synchronized, the kernels of the d = 32 logistic regression's main
paths at chip_smoke.py's shapes: AdaptiveHMC (8192 x (500 + 4000), L = 8),
HMC at the median adapted (eps-bar, M^-1) of that run (8192 x (499 + 4000)),
the ChEES frozen launch after its warmup (8192 x 4000), MEADS (8192 x (499 +
4000), K = 2, and the same launch on the d = 2 correlated Gaussian), Barker
(8192 x (499 + 4000) at a fixed eps = 0.03) and the evidence kernel (16 x 512
chains x (3000 + 3000)). The inputs are the same in every turn. It prints
the card's name and power limit, one line per turn, and a table of each
kernel's times with the mean of each side. Needs one CUDA GPU; it imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

KEY = 2024
C = 8192
N_WARM, N_DRAWS = 500, 4000
BARKER_EPS = 0.03
EV_CHAINS, EV_STEPS, EV_PRIOR_SCALE = 512, 3000, 10.0


def _time_in(root: str) -> dict:
    """The kernels' best-of-3 milliseconds in the checkout at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from advancedmh_tpu_torch import ChEESHMC, power_ladder
    from advancedmh_tpu_torch.models import correlated_gaussian_model, logistic_regression_model
    from advancedmh_tpu_torch.ops import (DualAveraging, MeadsParams, _build,
                                          fused_adaptive_hmc_sample, fused_barker_sample,
                                          fused_chees_frozen_sample, fused_hmc_sample,
                                          fused_meads_sample, fused_power_rwmh_sample,
                                          gaussian_prior_lp, minv_column)
    from advancedmh_tpu_torch.runtime.fused import (MAX_TILE, MEADS_BUDGET, fused_tile,
                                                    sample_fused_chees)

    _build.library()
    dev = "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False

    def best(fn):
        t_best, out = float("inf"), None
        for _ in range(3):
            out = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            t_best = min(t_best, time.perf_counter() - t0)
        return t_best * 1e3, out

    ms = {}
    lr = logistic_regression_model(256, 32, seed=0, device=dev)
    vg = lr.tile_value_and_grad
    x0 = torch.zeros(32, C, device=dev)
    lp0, g0 = vg(x0, *lr.tile_consts)
    args = (vg, lr.cuda_density, x0, lp0, g0, lr.tile_consts, KEY)
    kw = dict(n_leapfrog=8, warmup=N_WARM, thin=1, n_samples=N_DRAWS,
              da=DualAveraging(0.05, 0.65))
    ms["adaptive_hmc"], out = best(lambda: fused_adaptive_hmc_sample(*args, **kw))
    eps = float(torch.exp(out[3].median()))
    minv = minv_column(out[4].median(dim=1).values, 32, dev)
    del out
    kw = dict(step_size=eps, n_leapfrog=8, inverse_mass=minv, burn=N_WARM - 1, thin=1,
              n_samples=N_DRAWS)
    ms["hmc"], _ = best(lambda: fused_hmc_sample(*args, **kw))

    clock = {}
    _, st = sample_fused_chees(lr, ChEESHMC(initial_step_size=0.1, initial_trajectory_length=1.0,
                                            max_leapfrog=16), N_DRAWS, key=KEY + 70,
                               num_chains=C, initial_params=torch.zeros(32, device=dev),
                               num_warmup=N_WARM, discard_initial=N_WARM, thinning=1,
                               stage_clock=clock)
    fargs = (vg, lr.cuda_density, st.inner.params.T.contiguous(),
             st.inner.lp[None].contiguous(), st.inner.gradient.T.contiguous(), lr.tile_consts,
             KEY)
    kw = dict(trips=clock["trips"], phase=0,
              step_size=torch.exp(st.log_eps_bar[0:1]).reshape(1, 1),
              inverse_mass=st.inverse_mass[0].reshape(32, 1).contiguous(), thin=1,
              n_samples=N_DRAWS, iteration_offset=N_WARM)
    ms["chees_frozen"], _ = best(lambda: fused_chees_frozen_sample(*fargs, **kw))

    rng = np.random.default_rng(7)
    mom = torch.tensor(rng.normal(size=(32, C)), dtype=torch.float32, device=dev)
    u = torch.tensor(rng.uniform(size=(1, C)), dtype=torch.float32, device=dev)
    kw = dict(n_folds=2, t0=1, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS, params=MeadsParams(),
              tile_chains=fused_tile(C, MAX_TILE, 32, MEADS_BUDGET))
    ms["meads"], _ = best(lambda: fused_meads_sample(vg, lr.cuda_density, x0, lp0, g0, mom, u,
                                                     lr.tile_consts, KEY, **kw))
    m2 = correlated_gaussian_model([[1.5, 0.35], [0.35, 1.0]], device=dev)
    x2 = torch.zeros(2, C, device=dev)
    kw2 = dict(kw, tile_chains=fused_tile(C, MAX_TILE, 2, MEADS_BUDGET))
    ms["meads_d2"], _ = best(lambda: fused_meads_sample(
        m2.tile_value_and_grad, m2.cuda_density, x2, *m2.tile_value_and_grad(x2, *m2.tile_consts),
        mom[:2].contiguous(), u, m2.tile_consts, KEY, **kw2))

    kw = dict(step_size=BARKER_EPS, burn=N_WARM - 1, thin=1, n_samples=N_DRAWS)
    ms["barker"], _ = best(lambda: fused_barker_sample(*args, **kw))

    lik = logistic_regression_model(256, 32, seed=0, prior_scale=float("inf"), device=dev)
    Ce = 16 * EV_CHAINS
    rng = np.random.default_rng(KEY)
    s = EV_PRIOR_SCALE
    x = torch.tensor(rng.normal(0.0, s, (32, Ce)), dtype=torch.float32, device=dev)
    loc, scale = torch.zeros(32, device=dev), torch.full((32,), s, device=dev)
    ll = lik.tile_density(x, *lik.tile_consts)
    beta = torch.tensor(rng.choice(power_ladder(), Ce)[None], dtype=torch.float32, device=dev)
    plp = gaussian_prior_lp(x, loc[:, None], scale[:, None], torch.log(scale)[:, None])
    eargs = (lik.tile_density, lik.cuda_density, x, ll, plp, beta,
             torch.full((1, Ce), 0.5, device=dev), loc, scale, lik.tile_consts, KEY)
    ms["evidence"], _ = best(lambda: fused_power_rwmh_sample(*eargs, n_samples=EV_STEPS,
                                                             burn=EV_STEPS, adapt=True))
    return ms


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", help="checkout A (the parent)")
    ap.add_argument("--b", help="checkout B (the change)")
    ap.add_argument("--time-in", help="(a turn) time the kernels of this checkout")
    opts = ap.parse_args()
    if opts.time_in:
        print(json.dumps(_time_in(opts.time_in)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA GPU")
    card = _card()
    print(card)
    turns = []
    for side, root in (("A", opts.a), ("B", opts.b), ("B", opts.b), ("A", opts.a)):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-in", root],
                           capture_output=True, text=True)
        if r.returncode != 0:
            sys.exit(f"kernel_ab: the turn in {root} failed:\n{r.stdout}\n{r.stderr}")
        ms = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"turn {side} ({root}, {time.perf_counter() - t0:.1f} s): {json.dumps(ms)}",
              flush=True)
        turns.append((side, ms))
    print(f"[{card}] kernel ms, best of 3 a turn, turns A B B A")
    for name in turns[0][1]:
        row = [ms[name] for _, ms in turns]
        mean_a, mean_b = (row[0] + row[3]) / 2, (row[1] + row[2]) / 2
        print(f"{name:14s} " + " ".join(f"{v:10.4f}" for v in row)
              + f"   A {mean_a:10.4f}  B {mean_b:10.4f}  B/A {mean_b / mean_a:.4f}")


if __name__ == "__main__":
    main()
