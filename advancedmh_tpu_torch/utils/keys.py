"""RNG key plumbing: absolute-iteration indexing on ``torch.Generator``.

≙ advancedmh_tpu/utils/keys.py. A key here is a plain 64-bit integer. The
noise of step ``j`` comes from a generator seeded by ``fold_in(master, j)``
(init is ``j = 0``), so it depends only on (master seed, j) and never on the
state a generator was left in by earlier steps. That is what makes a run
split into chunks (``initial_state=`` + ``iteration_offset=``) bit-identical
to an unsplit one.

``fold_in`` is two rounds of splitmix64 (Steele, Lea & Flood 2014), the
usual finalizer for deriving independent 64-bit seeds from a counter.
"""
from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def splitmix64(x: int) -> int:
    """One splitmix64 output for state ``x`` (a bijection on 64-bit ints)."""
    z = (x + _GOLDEN) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def as_key(seed_or_key) -> int:
    """Coerce a Python or numpy integer seed to a 64-bit key."""
    if isinstance(seed_or_key, (bool, np.bool_)) or not isinstance(
        seed_or_key, (int, np.integer)
    ):
        raise TypeError(
            f"key must be an integer seed, got {type(seed_or_key).__name__}"
        )
    return int(seed_or_key) & MASK64


def fold_in(key: int, data: int) -> int:
    """Derive an independent key from ``key`` and the integer ``data``."""
    return splitmix64(key ^ splitmix64(int(data) & MASK64))


def generator(key: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``key``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(key & MASK64)
    return gen


def step_generator(master: int, j: int, device) -> torch.Generator:
    """The generator for absolute iteration ``j`` (init is ``j = 0``)."""
    return generator(fold_in(master, j), device)
