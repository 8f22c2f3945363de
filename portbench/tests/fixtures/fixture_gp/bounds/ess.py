"""The launches of a fused ESS call. Its operations follow the trips each
chain-step takes, which a launch does not report, so neither bytes nor
operations are counted: the readers of the kernel's roofline and of mfu
find nothing to read and return nothing."""
from __future__ import annotations


def launches(traffic: dict, plan: dict, launched: dict, C: int, N: int, d: int) -> list:
    return [("amh::ess_sample_kernel", None, None)] * launched.get("ess", 0)
