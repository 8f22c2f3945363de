"""Distribution protocol (≙ advancedmh_tpu/distributions/base.py).

Distributions are frozen dataclasses whose parameters are tensors or Python
numbers. ``sample`` takes an explicit ``torch.Generator`` and draws on that
generator's device; ``log_prob`` evaluates on the device of its argument.
"""
from __future__ import annotations

from typing import Tuple

import torch


def as_param(v, like: torch.Tensor) -> torch.Tensor:
    """A distribution parameter as a float32 tensor on ``like``'s device."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=torch.float32, device=like.device)


class Distribution:
    """Base class for all distributions.

    - ``sample(gen, sample_shape=())`` returns a tensor of shape
      ``sample_shape + batch_shape + event_shape``;
    - ``log_prob(x)`` returns a tensor of shape ``batch_shape``.

    A distribution without ``log_prob`` can only serve as a symmetric
    proposal: the Hastings term never evaluates it.
    """

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    def sample(
        self, gen: torch.Generator, sample_shape: Tuple[int, ...] = ()
    ) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement sample()."
        )

    def log_prob(self, x) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement log_prob(); "
            "it can only be used as a *symmetric* proposal "
            "(the Hastings correction never evaluates the proposal density)."
        )
