#!/usr/bin/env python3
"""Time the hand-written kernels of two checkouts of this repository on one
GPU, in turns: A, B, B, A.

    git archive <parent commit> | tar -x -C _archive/parent
    python3 tools/kernel_ab.py --a _archive/parent --b .

Several B checkouts (``--b one two ..``) run in turns A, B1 .. Bk, Bk .. B1,
A. ``--only rwmh`` or ``--only group`` times one of the two sets below.

Each turn is a fresh process that imports ``advancedmh_tpu_torch`` from its
checkout (building its kernels there at first use) and times, best of 3 and
CUDA-synchronized, the RWMH kernels (set ``rwmh``): the flagship's at the
benchmark cells' shapes from (0, 1), at scale 0.35 and (suffix ``_tril``)
at the lower-triangular [[0.35, 0], [0.1, 0.3]], ``rwmh_sample`` at 16384 x
(499 + 4000), ``rwmh_sample_thin`` at 16384 x (490 + 4000 x 10), ``rwmh``
at 16384 x 10000 steps; ``rwmh_sample_<density>`` on the d = 2 correlated
Gaussian and the emcee demo at 16384 x (499 + 4000) and on the d = 32
logistic regression at 8192 x (499 + 500), scale 0.02; and (set ``group``)
the kernels of the d = 32
logistic regression's main paths at chip_smoke.py's shapes: AdaptiveHMC
(8192 x (500 + 4000), L = 8), HMC at the median adapted (eps-bar, M^-1) of
that run (8192 x (499 + 4000)), the ChEES frozen launch after its warmup
(8192 x 4000), MEADS (8192 x (499 + 4000), K = 2, and the same launch on
the d = 2 correlated Gaussian), Barker
(8192 x (499 + 4000) at a fixed eps = 0.03), the evidence kernel (16 x 512
chains x (3000 + 3000)), elliptical slice sampling on the d = 64 GP
classification and regression (8192 x (499 + 4000), the prior's factor,
max_shrink 24, from prior draws) and pCN on the regression (8192 x (1999 +
4000), beta 0.2); these last three through the public fused_ess_sample and
fused_pcn_sample only. The inputs are the same in every turn. It prints
the card's name and power limit, one line per turn (with the seconds the
turn spent building its checkout's kernels), and a table of each kernel's
times with the mean of each side. Needs one CUDA GPU; it imports
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
PCN_WARM, PCN_BETA = 2000, 0.2
RWMH_CHAINS, RWMH_SCALE, RWMH_STEPS = 16384, 0.35, 10_000
RWMH_TRIL = [[0.35, 0.0], [0.1, 0.3]]


def _time_rwmh(best, dev) -> dict:
    """The RWMH kernels: the flagship's at the benchmark cells' shapes, at
    the per-dimension scale and a lower-triangular one, and three other
    densities' at one sampling shape each."""
    import torch

    from advancedmh_tpu_torch.models import (correlated_gaussian_model, emcee_demo_model,
                                             gaussian_mean_scale_model,
                                             logistic_regression_model)
    from advancedmh_tpu_torch.ops import fused_rwmh, fused_rwmh_sample

    def args_of(m, start, C, scale):
        x = torch.tensor(start, device=dev).reshape(-1, 1).expand(len(start), C).contiguous()
        return (m.tile_density, m.cuda_density, x, m.tile_density(x, *m.tile_consts), scale,
                m.tile_consts, KEY)

    def sample(args, burn, thin, n):
        return best(lambda: fused_rwmh_sample(*args, burn=burn, thin=thin, n_samples=n))[0]

    flagship = gaussian_mean_scale_model(device=dev)
    ms = {}
    for form, scale in (("", RWMH_SCALE), ("_tril", torch.tensor(RWMH_TRIL, device=dev))):
        args = args_of(flagship, [0.0, 1.0], RWMH_CHAINS, scale)
        for name, thin in (("rwmh_sample", 1), ("rwmh_sample_thin", 10)):
            ms[name + form] = sample(args, N_WARM - thin, thin, N_DRAWS)
        ms["rwmh" + form], _ = best(lambda: fused_rwmh(*args, n_steps=RWMH_STEPS))
    others = (
        ("corr2", correlated_gaussian_model([[1.5, 0.35], [0.35, 1.0]], device=dev), [0.0, 0.0],
         RWMH_CHAINS, RWMH_SCALE, N_DRAWS),
        ("emcee", emcee_demo_model(device=dev), [2.0, 1.0], RWMH_CHAINS, RWMH_SCALE, N_DRAWS),
        ("logreg", logistic_regression_model(256, 32, seed=0, device=dev), [0.0] * 32, C, 0.02,
         500),
    )
    for name, m, start, n_chains, scale, n in others:
        ms[f"rwmh_sample_{name}"] = sample(args_of(m, start, n_chains, scale), N_WARM - 1, 1, n)
    return ms


def _time_in(root: str, only: str = None) -> dict:
    """The kernels' best-of-3 milliseconds in the checkout at ``root`` (the
    set ``only``, or both), and the seconds its kernels took to build in
    this turn (0 when built before)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from advancedmh_tpu_torch import ChEESHMC, power_ladder
    from advancedmh_tpu_torch.models import (correlated_gaussian_model, gp_latent_model,
                                             logistic_regression_model)
    from advancedmh_tpu_torch.ops import (DualAveraging, MeadsParams, _build,
                                          fused_adaptive_hmc_sample, fused_barker_sample,
                                          fused_chees_frozen_sample, fused_ess_sample,
                                          fused_hmc_sample, fused_meads_sample,
                                          fused_pcn_sample, fused_power_rwmh_sample,
                                          gaussian_prior_lp, minv_column)
    from advancedmh_tpu_torch.runtime.fused import (MAX_TILE, MEADS_BUDGET, fused_tile,
                                                    sample_fused_chees)

    _, build_s, _ = _build.build()
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

    ms = {} if only == "group" else _time_rwmh(best, dev)
    if only == "rwmh":
        return {"build_s": build_s, "ms": ms}
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

    for name, kw in (("ess_class64", dict(likelihood="logistic", seed=5)),
                     ("ess_reg64", dict(noise=0.3, seed=3))):
        m, prior, _ = gp_latent_model(64, **kw, device=dev)
        x = prior.sample(torch.Generator(device=dev).manual_seed(123), (C,)).T.contiguous()
        gargs = (m.tile_density, m.cuda_density, x, m.tile_density(x, *m.tile_consts),
                 torch.zeros(64, device=dev), prior.scale_tril, m.tile_consts, KEY)
        ms[name], _ = best(lambda: fused_ess_sample(*gargs, max_shrink=24, burn=N_WARM - 1,
                                                    thin=1, n_samples=N_DRAWS))
    ms["pcn"], _ = best(lambda: fused_pcn_sample(*gargs, beta=PCN_BETA, burn=PCN_WARM - 1,
                                                 thin=1, n_samples=N_DRAWS))
    return {"build_s": build_s, "ms": ms}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--a", help="checkout A (the parent)")
    ap.add_argument("--b", nargs="+", help="checkout B (the change), or several")
    ap.add_argument("--only", choices=("rwmh", "group"), help="time one set of kernels")
    ap.add_argument("--time-in", help="(a turn) time the kernels of this checkout")
    opts = ap.parse_args()
    if opts.time_in:
        print(json.dumps(_time_in(opts.time_in, opts.only)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: needs a CUDA GPU")
    card = _card()
    print(card)
    sides = [("A", opts.a)] + [(f"B{i + 1}" if len(opts.b) > 1 else "B", root)
                               for i, root in enumerate(opts.b)]
    turns = []
    for side, root in sides + sides[::-1]:
        t0 = time.perf_counter()
        cmd = [sys.executable, os.path.abspath(__file__), "--time-in", root]
        r = subprocess.run(cmd + (["--only", opts.only] if opts.only else []),
                           capture_output=True, text=True)
        if r.returncode != 0:
            sys.exit(f"kernel_ab: the turn in {root} failed:\n{r.stdout}\n{r.stderr}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        ms = out["ms"]
        print(f"turn {side} ({root}, {time.perf_counter() - t0:.1f} s, build "
              f"{out['build_s']:.1f} s): {json.dumps(ms)}", flush=True)
        turns.append((side, ms))
    order = " ".join(side for side, _ in turns)
    print(f"[{card}] kernel ms, best of 3 a turn, turns {order}; each side's mean, and B/A")
    for name in turns[0][1]:
        mean = {side: sum(ms[name] for sd, ms in turns if sd == side) / 2 for side, _ in sides}
        print(f"{name:16s} " + " ".join(f"{ms[name]:10.4f}" for _, ms in turns) + "  "
              + "  ".join(f"{side} {mean[side]:10.4f}" + ("" if side == "A" else
                                                         f" ({mean[side] / mean['A']:.4f})")
                          for side, _ in sides))


if __name__ == "__main__":
    main()
