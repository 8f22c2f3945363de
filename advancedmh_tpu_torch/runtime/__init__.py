from .sample import (
    MCMCDistributed,
    MCMCSerial,
    MCMCThreads,
    SamplingResult,
    build_chain_fn,
    sample,
)
from .schedule import Schedule

__all__ = [
    "MCMCDistributed", "MCMCSerial", "MCMCThreads", "SamplingResult",
    "build_chain_fn", "sample", "Schedule",
]
