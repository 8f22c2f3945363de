"""Iteration schedule bookkeeping.

Encodes the AbstractMCMC driver-loop contract the reference relies on
(exercised at reference test/runtests.jl:123-178 and
src/RobustAdaptiveMetropolis.jl:42-43):

- iteration 0 is the *init* draw (it emits a sample: reference
  test/runtests.jl:203-213 asserts ``chain[1].params == initial_params``);
- iterations 1..T are steps, where step j uses ``step_warmup`` iff
  ``j <= num_warmup``;
- the kept samples are iterations ``discard_initial + i*thinning`` for
  ``i = 0..n_samples-1`` (so ``T = discard_initial + (n_samples-1)*thinning``),
  labeled ``discard_initial + 1`` onwards with stride ``thinning`` (matching
  MCMCChains ``start``/``thin``);
- ``discard_initial`` defaults to ``num_warmup`` (warmup samples dropped).

The fused engines never emit the init state: their sample k is the state
after ``burn + (k+1)*thinning`` steps (:attr:`Schedule.burn`), and the
adaptive ones take only the schedules :meth:`Schedule.check_adaptive`
accepts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Schedule:
    n_samples: int
    num_warmup: int = 0
    discard_initial: Optional[int] = None
    thinning: int = 1

    def __post_init__(self):
        if self.discard_initial is None:
            object.__setattr__(self, "discard_initial", self.num_warmup)
        if self.n_samples < 1:
            raise ValueError("n_samples must be >= 1")
        if self.thinning < 1:
            raise ValueError("thinning must be >= 1")
        if self.discard_initial < 0 or self.num_warmup < 0:
            raise ValueError("num_warmup/discard_initial must be >= 0")

    @property
    def total_steps(self) -> int:
        """Steps after init: T = discard_initial + (n_samples-1)*thinning."""
        return self.discard_initial + (self.n_samples - 1) * self.thinning

    @property
    def start(self) -> int:
        """1-based label of the first kept sample (≙ Chains ``start``)."""
        return self.discard_initial + 1

    def iterations(self) -> range:
        """≙ MCMCChains ``range(chain)``."""
        return range(
            self.start, self.start + self.n_samples * self.thinning, self.thinning
        )

    @property
    def burn(self) -> int:
        """The fused engines' steps before their first emission:
        ``discard_initial - thinning``, or none where that is negative. Their
        sample k is the state after ``burn + (k+1)*thinning`` steps, the
        standard schedule when ``discard_initial >= thinning``."""
        return max(self.discard_initial - self.thinning, 0)

    def check_adaptive(self, name: str, resume: bool) -> None:
        """Raise unless a fused adaptive sampler ``name`` can run this
        schedule: a fresh run drops its warmup (``discard_initial ==
        num_warmup``), a resumed one continues frozen (``num_warmup == 0``,
        ``discard_initial == thinning``)."""
        if resume:
            if self.num_warmup != 0 or self.discard_initial != self.thinning:
                raise ValueError(
                    f"fused {name} resume expects the chunk-resume schedule "
                    "(num_warmup=0, discard_initial=thinning).")
        elif self.discard_initial != self.num_warmup:
            raise ValueError(
                f"fused {name} supports the standard schedule discard_initial == "
                "num_warmup; use engine='torch' to keep warmup draws.")
