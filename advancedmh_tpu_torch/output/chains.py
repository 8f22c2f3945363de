"""Chains output container (≙ advancedmh_tpu/output/chains.py).

Layout is ``(n_samples, n_params, n_chains)``, the MCMCChains convention,
with an ``lp`` internals column and ``start``/``thin`` iteration labels.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..diagnostics import rhat
from ..diagnostics.ess import ess_and_value
from ..utils.trace import host_sync, span, traced


def _std(x: torch.Tensor) -> torch.Tensor:
    return torch.std(x, correction=0)


def _statistic(name: str, fn, *args) -> Tuple[torch.Tensor, float]:
    """``fn(*args)`` and its value read to the host, as the span ``name``."""
    with span(name):
        t = fn(*args)
        return t, host_sync("summary", float, t)


class Chains:
    def __init__(
        self,
        values: torch.Tensor,  # (n_samples, n_params, n_chains)
        lp: torch.Tensor,  # (n_samples, n_chains)
        names: Sequence[str],
        start: int = 1,
        thin: int = 1,
    ):
        self.values = values
        self.lp = lp
        self.names = list(names)
        self.internals = ["lp"]
        self.start = start
        self.thin = thin
        if values.ndim != 3:
            raise ValueError("values must be (n_samples, n_params, n_chains)")
        if len(self.names) != values.shape[1]:
            raise ValueError("names length must match n_params")

    @property
    def n_samples(self) -> int:
        return self.values.shape[0]

    @property
    def n_params(self) -> int:
        return self.values.shape[1]

    @property
    def n_chains(self) -> int:
        return self.values.shape[2]

    @property
    def range(self) -> range:
        """≙ MCMCChains ``range(chain)``: iteration labels."""
        return range(self.start, self.start + self.n_samples * self.thin, self.thin)

    @property
    def array(self) -> torch.Tensor:
        """(n_samples, n_params+1, n_chains) with the lp column."""
        return torch.cat([self.values, self.lp[:, None, :]], dim=1)

    def __getitem__(self, name: str) -> torch.Tensor:
        """Draws of one parameter, (n_samples, n_chains)."""
        if name == "lp":
            return self.lp
        return self.values[:, self.names.index(name), :]

    def __repr__(self) -> str:
        return (
            f"Chains({self.n_samples} samples × {self.n_params} params × "
            f"{self.n_chains} chains, start={self.start}, thin={self.thin}, "
            f"params={self.names})"
        )

    def mean(self, name: Optional[str] = None):
        if name is not None:
            return torch.mean(self[name])
        return torch.mean(self.values, dim=(0, 2))

    def std(self, name: Optional[str] = None):
        if name is not None:
            return torch.std(self[name], correction=0)
        return torch.std(self.values, dim=(0, 2), correction=0)

    def cov(self) -> torch.Tensor:
        """Covariance of the flattened draws, (n_params, n_params)."""
        flat = self.values.permute(0, 2, 1).reshape(-1, self.n_params)
        return torch.cov(flat.T)

    @traced("summary")
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-parameter mean/std/naive_se/mcse/ess/rhat (≙ MCMCChains
        summarystats). Each statistic is the span ``summary.<statistic>``,
        its host read the sync ``summary``. ESS is computed once a parameter:
        mcse is std / √ESS of the same tensors."""
        out: Dict[str, Dict[str, float]] = {}
        for i, name in enumerate(self.names):
            x = self.values[:, i, :]
            n_total = x.shape[0] * x.shape[1]
            std_t, std = _statistic("summary.std", _std, x)
            _, mean = _statistic("summary.mean", torch.mean, x)
            with span("summary.ess"):
                ess_t, ess = ess_and_value(x, "summary")
            _, mcse = _statistic("summary.mcse", lambda: std_t / torch.sqrt(ess_t))
            _, rhat_value = _statistic("summary.rhat", rhat, x)
            out[name] = {"mean": mean, "std": std, "naive_se": std / n_total**0.5,
                         "mcse": mcse, "ess": ess, "rhat": rhat_value}
        return out

    @staticmethod
    def cat(*chains: "Chains") -> "Chains":
        """Concatenate along the chain axis (≙ ``chainscat``)."""
        first = chains[0]
        for c in chains[1:]:
            if c.names != first.names:
                raise ValueError("Cannot chainscat chains with different params")
        return Chains(
            torch.cat([c.values for c in chains], dim=2),
            torch.cat([c.lp for c in chains], dim=1),
            first.names,
            start=first.start,
            thin=first.thin,
        )
