"""Plain elliptical slice sampling (Murray, Adams & MacKay 2010, §2), the
reference of the fused ESS path.

Restated from ``advancedmh_tpu_torch/ops/ess.py`` (``ess_trips``,
``ess_sample_reference``) over a batch of (chain, step) pairs. The target
is the log-likelihood ℓ with a Gaussian prior N(μ, L Lᵀ) (:class:`Target`).
A step draws ν − μ = L z, log y = ℓ(x) + log U and θ = 2π·U_θ with the
bracket [θ − 2π, θ]; trip k tries x' = μ + (x − μ) cos θ + (ν − μ) sin θ,
accepts iff ℓ(x') > log y, else shrinks the bracket to the rejected θ on its
own side of 0 and draws θ = θ_min + U_k (θ_max − θ_min). A chain that
exhausts ``max_shrink`` trips keeps its state and reports no accept.

Noise of absolute step j of a chain (:func:`noise`): the d normals'
Box-Muller words 0 .. 2P − 1, U (word 2P), U_θ (2P + 1), then trip k's
uniform at word 2P + 2 + k: 2P + 2 + ``max_shrink`` Philox words a step.
Draw k of a call is the state after ``burn + (k + 1)·thin`` steps, as in
``reference/rwmh.py``. Plain PyTorch; imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from . import philox


class Target:
    """The log-likelihood ``loglik(points (M, d)) -> (M,)`` (called as the
    target) and the Gaussian prior's mean ``loc`` (d,) and lower Cholesky
    factor ``tril`` (d, d)."""

    def __init__(self, loglik: Callable, loc: torch.Tensor, tril: torch.Tensor):
        self.loglik, self.loc, self.tril = loglik, loc, tril

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.loglik(x)


def plan(traffic: dict) -> dict:
    """What a replay needs beyond the noise: the trips a step may take and
    the schedule."""
    thin = int(traffic["thinning"])
    return {"max_shrink": int(traffic["sampler"]["kwargs"]["max_shrink"]),
            "burn": max(int(traffic["discard_initial"]) - thin, 0), "thin": thin}


def steps_before(plan_: dict, k: int) -> int:
    """Steps of the call before draw k."""
    return plan_["burn"] + (k + 1) * plan_["thin"]


class StepWords:
    """The noise of consecutive steps of chains ``chain`` (M,), from
    absolute steps ``first`` (M,) on: ``next()`` returns the step's normals
    (M, d), log U (M,), U_θ (M,) and trip uniforms (M, n_trips). Philox
    runs on ``chunk`` steps at once."""

    def __init__(self, seed: int, chain: torch.Tensor, first: torch.Tensor, d: int,
                 n_trips: int, dtype=torch.float64, chunk: int = 1):
        self.seed, self.chain, self.d, self.n_trips, self.dtype = seed, chain, d, n_trips, dtype
        self.first = first.to(torch.int64).reshape(-1)
        self.chunk = max(1, int(chunk))
        self.t = 0
        self.buf = None

    def next(self):
        i = self.t % self.chunk
        if i == 0:
            M = self.chain.numel()
            ts = torch.arange(self.t, self.t + self.chunk, device=self.first.device)
            steps = (self.first.reshape(1, M) + ts.reshape(-1, 1)).reshape(-1)
            P = (self.d + 1) // 2
            u = philox.uniforms(self.seed, steps, self.chain.repeat(self.chunk),
                                2 * P + 2 + self.n_trips, self.dtype)
            r = torch.sqrt(-2.0 * torch.log(u[:, 0:2 * P:2]))
            theta = (2.0 * math.pi) * u[:, 1:2 * P:2]
            z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
            z = z.reshape(-1, 2 * P)[:, :self.d]
            self.buf = (z.reshape(self.chunk, M, self.d),
                        torch.log(u[:, 2 * P]).reshape(self.chunk, M),
                        u[:, 2 * P + 1].reshape(self.chunk, M),
                        u[:, 2 * P + 2:].reshape(self.chunk, M, self.n_trips))
        self.t += 1
        return tuple(b[i] for b in self.buf)


def noise(plan_: dict, seed: int, chain: torch.Tensor, first: torch.Tensor, d: int,
          dtype=torch.float64, chunk: int = 1) -> StepWords:
    """The noise :func:`replay` consumes (:class:`StepWords`), with the
    plan's ``max_shrink`` trip uniforms a step."""
    return StepWords(seed, chain, first, d, plan_["max_shrink"], dtype, chunk)


def replay(target: Target, plan_: dict, noise: StepWords, x: torch.Tensor,
           n_steps: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run ``n_steps`` steps from points ``x`` (M, d) under the next steps of
    ``noise``. Returns the end points, their log-likelihoods and the last
    step's decisions."""
    lp = target(x)
    loc, tril = target.loc.to(x.dtype), target.tril.to(x.dtype)
    done = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for _ in range(n_steps):
        z, logu, u_theta, trip_u = (t.to(x.dtype) for t in noise.next())
        nu_c = z @ tril.T
        logy = lp + logu
        theta = (2.0 * math.pi) * u_theta
        tmin, tmax = theta - 2.0 * math.pi, theta
        done = torch.zeros_like(done)
        for k in range(plan_["max_shrink"]):
            cand = loc + (x - loc) * torch.cos(theta)[:, None] + nu_c * torch.sin(theta)[:, None]
            lp_c = target(cand)
            newly = (lp_c > logy) & ~done
            x = torch.where(newly[:, None], cand, x)
            lp = torch.where(newly, lp_c, lp)
            done = done | newly
            tmin = torch.where(~done & (theta < 0), theta, tmin)
            tmax = torch.where(~done & (theta >= 0), theta, tmax)
            theta = tmin + trip_u[:, k] * (tmax - tmin)
    return x, lp, done
