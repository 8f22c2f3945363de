"""The driver of ``"call": "sample"`` traffic: one call is
``sample(..., engine="fused")`` fenced by a synchronize, then
``SamplingResult.to_chains()`` and ``Chains.summary()``; it completes the
smallest ESS of ``summary()`` over the configuration's parameters.

The traffic file names the sampler as the program's public constructor and
its arguments (``builder.build``; an argument ``{"config": key}`` is made by
the configuration's ``program_objects``), the chain count, the schedule
(``n_samples``, ``num_warmup``, ``discard_initial``, ``thinning``), the
initial point, the reference (``reference/<name>.py``) that judges the
draws and, optionally, the module of the kernels' counts
(``"bounds"``: ``bounds/<name>.py``, the reference's name by default) and
``"warm_ess_fallback": true`` where some of the cell's calls take
``summary()``'s FFT fallback (Geyer's sequence past the lag window): set-up
then runs that fallback once at the calls' shape, so that cuFFT's load and
plans fall in set-up and not in the call that first needs them.
"""
from __future__ import annotations

import importlib

import torch

from portbench import judge
from portbench.builder import build, config_objects


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class SampleDriver:
    def __init__(self, cell, cfgmod, data, device):
        import advancedmh_tpu_torch as amh

        self.amh, self.cell, self.cfgmod, self.data = amh, cell, cfgmod, data
        self.device = torch.device(device)
        t = cell.traffic
        self.traffic = t
        self.model = cfgmod.program_model(cell.config, data, device)
        objects = config_objects(cell, cfgmod, data, device)
        self.sampler = build(t["sampler"], amh, device, objects)
        self.initial = torch.as_tensor(build(t["initial_params"], amh, device, objects),
                                       dtype=torch.float32, device=device)
        self.names = list(cell.config["param_names"])
        self.n_samples = int(t["n_samples"])
        self.kwargs = dict(num_chains=int(t["num_chains"]), engine="fused",
                           num_warmup=int(t["num_warmup"]),
                           discard_initial=int(t["discard_initial"]),
                           thinning=int(t["thinning"]), initial_params=self.initial)
        self.reference = importlib.import_module(f"portbench.reference.{t['reference']}")
        self.bounds = importlib.import_module(
            f"portbench.bounds.{t.get('bounds', t['reference'])}")
        if t.get("warm_ess_fallback"):
            self.warm_ess_fallback()

    def warm_ess_fallback(self) -> None:
        """The program's FFT ESS once on an (n_samples, chains) float32 block,
        the shape of one parameter's draws in ``summary()``; no host read."""
        from advancedmh_tpu_torch.diagnostics.ess import ess_fallback

        gen = torch.Generator(self.device).manual_seed(0)
        x = torch.randn((self.n_samples, self.kwargs["num_chains"]), generator=gen,
                        dtype=torch.float32, device=self.device)
        ess_fallback(x, "summary", read=False)
        _sync(self.device)

    def run(self, key: int, span):
        with span("sample"):
            result = self.amh.sample(self.model, self.sampler, self.n_samples, key=key,
                                     **self.kwargs)
            _sync(self.device)
        with span("summary"):
            summary = result.to_chains(param_names=self.names).summary()
        return {"ess": min(s["ess"] for s in summary.values())}, (result, summary)

    # ---- what a traced call launched, for the per-layer metrics ----

    def info(self, handle, launched: dict) -> dict:
        """The launches of one call with the bytes and float32 operations
        each needs."""
        plan = self.reference.plan(self.traffic)
        return {"launches": self.bounds.launches(self.traffic, plan, launched,
                                                 self.kwargs["num_chains"], self.n_samples,
                                                 self.initial.numel())}

    # ---- the check after the window ----

    def judge(self, key: int, handle, seed: int):
        result, summary = handle
        tr = result.transitions
        draws = judge.Draws(tr.params, tr.lp, tr.accepted, summary)
        return self.judge_draws(draws, key, seed)

    def judge_draws(self, draws, key: int, seed: int):
        logp64 = self.cfgmod.reference_logp(self.cell.config, self.data, torch.float64)
        return judge.judge_draws(draws, self.reference, self.traffic, logp64, self.initial, key,
                                 seed, self.names, self.traffic["limits"])


def prepare(cell, cfgmod, data, device) -> SampleDriver:
    return SampleDriver(cell, cfgmod, data, device)
