"""advancedmh_tpu_torch — the Metropolis-Hastings framework on PyTorch and CUDA.

The port of ``advancedmh_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It carries the reference sampler surface end to end: distributions,
models, proposal trees, the MH sampler (RWMH), MALA, Robust Adaptive
Metropolis, the emcee ensemble, HMC, AdaptiveHMC, dual-averaging step-size
adaptation, ChEES-HMC, MEADS, slice sampling, elliptical slice sampling,
the Barker proposal, preconditioned Crank-Nicolson, Adaptive Metropolis,
delayed rejection, DRAM, Multiple-Try Metropolis, replica exchange and
differential-evolution MCMC, the evidence estimators (``log_evidence``
with its power-posterior ladder, ``log_evidence_ais``) and adaptive-tempering
SMC (``smc_sample``), ``sample`` with a
batched tensor engine (``engine="torch"``) and the hand-written CUDA kernels
of the fused engine (``engine="fused"``, ``csrc/``), ``Chains`` and the
ESS / R̂ / MCSE diagnostics. Public names match ``advancedmh_tpu``'s. Models live on the
card unless the caller passes another ``device``. The package imports torch
and numpy and never jax; the kernels are built with nvcc at their first
launch.
"""

from .distributions import (
    Beta,
    Cauchy,
    Distribution,
    Exponential,
    Gamma,
    InverseGamma,
    Laplace,
    LogNormal,
    MvNormal,
    Normal,
    StudentT,
    TDist,
    Uniform,
)
from .models import (
    CapabilityOrder,
    DensityModel,
    as_model,
    guarded_logdensity,
    logdensity,
    logdensity_and_gradient,
)
from .proposals import (
    Proposal,
    RandomWalkProposal,
    StaticProposal,
    SymmetricRandomWalkProposal,
    SymmetricStaticProposal,
    logratio_proposal_density,
    propose,
    propose_initial,
    q,
)
from .samplers import (
    DRAM,
    MALA,
    RWMH,
    AdaptiveHMC,
    AdaptiveHMCState,
    AdaptiveMetropolis,
    AdaptiveMetropolisState,
    Barker,
    ChEESHMC,
    ChEESHMCState,
    DelayedRejection,
    DifferentialEvolution,
    EllipticalSlice,
    Ensemble,
    GradientTransition,
    HamiltonianMC,
    MEADS,
    MEADSState,
    MetropolisHastings,
    MultipleTryMetropolis,
    PreconditionedCrankNicolson,
    ReplicaExchange,
    ReplicaExchangeState,
    RobustAdaptiveMetropolis,
    RobustAdaptiveMetropolisState,
    SliceSampler,
    StaticMH,
    StepSizeAdaptation,
    StepSizeAdaptationState,
    StretchProposal,
    Transition,
    WalkProposal,
    getparams,
    setparams,
    swap_rates,
    tune_betas,
)
from .runtime import (
    MCMCDistributed,
    MCMCSerial,
    MCMCThreads,
    SamplingResult,
    Schedule,
    log_evidence,
    log_evidence_ais,
    power_ladder,
    sample,
    smc_sample,
)
from .output import Chains, StructArray, chainscat
from .diagnostics import ess, ess_bulk, ess_tail, mcse, rhat, rhat_rank
from .utils.trace import tracing

__version__ = "0.1.0"

__all__ = [
    # distributions
    "Distribution", "Normal", "MvNormal", "LogNormal", "Uniform",
    "Exponential", "Laplace", "Cauchy", "StudentT", "TDist", "Gamma",
    "InverseGamma", "Beta",
    # models
    "DensityModel", "CapabilityOrder", "as_model", "logdensity",
    "logdensity_and_gradient", "guarded_logdensity",
    # proposals
    "Proposal", "StaticProposal", "RandomWalkProposal",
    "SymmetricStaticProposal", "SymmetricRandomWalkProposal",
    "propose", "propose_initial", "q", "logratio_proposal_density",
    # samplers
    "MetropolisHastings", "StaticMH", "RWMH", "Transition",
    "GradientTransition", "MALA", "RobustAdaptiveMetropolis",
    "RobustAdaptiveMetropolisState", "Ensemble", "StretchProposal",
    "WalkProposal", "HamiltonianMC", "AdaptiveHMC", "AdaptiveHMCState",
    "StepSizeAdaptation", "StepSizeAdaptationState", "ChEESHMC", "ChEESHMCState",
    "MEADS", "MEADSState", "SliceSampler", "EllipticalSlice", "Barker",
    "PreconditionedCrankNicolson", "AdaptiveMetropolis", "AdaptiveMetropolisState",
    "DelayedRejection", "DRAM", "MultipleTryMetropolis", "ReplicaExchange",
    "ReplicaExchangeState", "swap_rates", "tune_betas", "DifferentialEvolution",
    "getparams", "setparams",
    # runtime
    "sample", "Schedule", "SamplingResult",
    "MCMCSerial", "MCMCThreads", "MCMCDistributed",
    "log_evidence", "log_evidence_ais", "power_ladder", "smc_sample",
    # output / diagnostics
    "Chains", "StructArray", "chainscat", "ess", "ess_bulk", "ess_tail",
    "rhat", "rhat_rank", "mcse",
    # tracing
    "tracing",
]
