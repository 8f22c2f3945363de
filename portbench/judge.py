"""The comparisons that decide ``correct``.

Each number is compared with the limit the cell's traffic file gives it
(``limits``); PERF.md says from which readings each limit was set. The
reference runs in float64 after the window, on the device the program ran
on, from the same inputs; it reads the program's outputs only to judge them.

Sampling calls (``sample`` + ``summary()``):

- ``transition_mismatch``: of transitions drawn from the seed (a chain and a
  draw k >= 1), the share whose replay by the reference from the program's
  draw k - 1 (``thin`` steps under the same noise) does not reach the
  program's draw k within ``X_TOL`` (relative, with 1 added to the scale),
  or ends on another decision. Chains drawn from the seed are also replayed
  from the initial point to their first draw, and count the same.
- ``lp_gap``: the widest gap between the program's log density of a drawn
  sample and the reference's, relative to max(1, |reference|).
- ``summary_gap``: the widest gap between a statistic of the program's
  ``summary()`` and the reference's of the same draws: the mean relative to
  the std, R-hat absolute, the others relative.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import torch

from portbench.reference import philox
from portbench.reference import summary as ref_summary

X_TOL = 1e-4
N_TRANSITIONS = 8192
N_STARTS = 256


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Draws:
    """What a sampling call produced, in the program's layout: draws (C, N,
    d), log densities and decisions (C, N) and the summary() it returned."""
    params: torch.Tensor
    lp: torch.Tensor
    accepted: torch.Tensor
    summary: Dict[str, Dict[str, float]]


def index_generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(philox.fold_in(seed, 0x5EED) & philox.MASK64)
    return g


def mismatched(x_ref, x_got, acc_ref, acc_got) -> torch.Tensor:
    far = (x_ref - x_got).abs() > X_TOL * (1.0 + x_ref.abs())
    return far.any(dim=1) | (acc_ref != acc_got)


def judge_draws(draws: Draws, ref, traffic: dict, logp64: Callable,
                initial: torch.Tensor, key: int, seed: int,
                names: List[str], limits: Dict[str, float]) -> List[Check]:
    """The numbers of a sampling call (see the module's doc). ``ref`` is the
    cell's reference module, whose ``noise`` makes the stream its ``replay``
    consumes; ``logp64`` is the float64 target ``ref.replay`` steps with;
    ``initial`` the initial point."""
    plan = ref.plan(traffic)
    C, N, d = draws.params.shape
    dev = draws.params.device
    g = index_generator(seed)
    c = torch.randint(C, (N_TRANSITIONS,), generator=g).to(dev)
    k = torch.randint(1, N, (N_TRANSITIONS,), generator=g).to(dev)
    kseed = philox.kernel_seed(key)
    thin = plan["thin"]
    first = plan["burn"] + k * thin + 1
    noise = ref.noise(plan, kseed, c, first, d, torch.float64, thin)
    x_ref, _, acc_ref = ref.replay(logp64, plan, noise, draws.params[c, k - 1].double(), thin)
    bad = mismatched(x_ref, draws.params[c, k].double(), acc_ref, draws.accepted[c, k])
    n_bad, n_all = int(bad.sum()), bad.numel()
    c0 = torch.randint(C, (N_STARTS,), generator=g).to(dev)
    x0 = initial.double().to(dev).reshape(1, d).expand(N_STARTS, d)
    first0 = torch.ones(N_STARTS, dtype=torch.long, device=dev)
    n0 = ref.steps_before(plan, 0)
    noise0 = ref.noise(plan, kseed, c0, first0, d, torch.float64, 64)
    x_ref0, _, acc0 = ref.replay(logp64, plan, noise0, x0, n0)
    bad0 = mismatched(x_ref0, draws.params[c0, 0].double(), acc0, draws.accepted[c0, 0])
    n_bad, n_all = n_bad + int(bad0.sum()), n_all + bad0.numel()
    lp_ref = logp64(draws.params[c, k].double())
    lp_gap = float(((draws.lp[c, k].double() - lp_ref).abs()
                    / torch.clamp(lp_ref.abs(), min=1.0)).nan_to_num(math.inf).max())
    checks = [Check("transition_mismatch", n_bad / n_all, limits["transition_mismatch"]),
              Check("lp_gap", lp_gap, limits["lp_gap"])]
    checks.append(Check("summary_gap", summary_gap(draws, names), limits["summary_gap"]))
    return checks


def summary_gap(draws: Draws, names: List[str]) -> float:
    values = draws.params.permute(1, 2, 0)  # (N, d, C), as Chains holds them
    ref = ref_summary.summarize(values, names, torch.float64)
    worst = 0.0
    for name in names:
        got, want = draws.summary[name], ref[name]
        for stat, w in want.items():
            diff = abs(got[stat] - w)
            scale = want["std"] if stat == "mean" else 1.0 if stat == "rhat" else abs(w)
            worst = max(worst, relative(diff, scale))
    return worst


def relative(diff: float, scale: float) -> float:
    """diff / scale; 0 for no difference, inf where the scale is 0 or either
    is not finite."""
    if diff == 0.0:
        return 0.0
    gap = diff / scale if scale > 0.0 else math.inf
    return gap if math.isfinite(gap) else math.inf
