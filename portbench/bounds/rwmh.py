"""The launches of a fused RWMH call, with the bytes and float32 operations
each needs (``rwmh_sample``)."""
from __future__ import annotations

from portbench.bounds import rwmh_sample


def launches(traffic: dict, plan: dict, launched: dict, C: int, N: int, d: int) -> list:
    nb, fl = rwmh_sample(C, plan["burn"] + N * plan["thin"], N, d)
    return [("amh::rwmh_sample_kernel", nb, fl)] * launched.get("rwmh_sample", 0)
