from .sample import (
    MCMCDistributed,
    MCMCSerial,
    MCMCThreads,
    SamplingResult,
    build_chain_fn,
    sample,
)
from .evidence import log_evidence, log_evidence_ais, power_ladder
from .schedule import Schedule
from .smc import smc_sample

__all__ = [
    "MCMCDistributed", "MCMCSerial", "MCMCThreads", "SamplingResult",
    "build_chain_fn", "sample", "Schedule", "log_evidence", "log_evidence_ais",
    "power_ladder", "smc_sample",
]
