"""advancedmh_tpu_torch — the Metropolis-Hastings framework on PyTorch and CUDA.

The port of ``advancedmh_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
This slice carries the RWMH main path end to end: distributions, models,
proposal trees, the MH sampler, ``sample`` with a batched tensor engine
(``engine="torch"``) and the hand-written CUDA kernels of the fused engine
(``engine="fused"``, ``csrc/``), ``Chains`` and the ESS / R̂ / MCSE
diagnostics. Public names match ``advancedmh_tpu``'s. The package imports
torch and numpy and never jax; the kernels are built with nvcc at their
first launch.
"""

from .distributions import Distribution, MvNormal, Normal
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
    RWMH,
    MetropolisHastings,
    StaticMH,
    Transition,
    getparams,
    setparams,
)
from .runtime import (
    MCMCDistributed,
    MCMCSerial,
    MCMCThreads,
    SamplingResult,
    Schedule,
    sample,
)
from .output import Chains, StructArray, chainscat
from .diagnostics import ess, ess_bulk, ess_tail, mcse, rhat, rhat_rank

__version__ = "0.1.0"

__all__ = [
    # distributions
    "Distribution", "Normal", "MvNormal",
    # models
    "DensityModel", "CapabilityOrder", "as_model", "logdensity",
    "logdensity_and_gradient", "guarded_logdensity",
    # proposals
    "Proposal", "StaticProposal", "RandomWalkProposal",
    "SymmetricStaticProposal", "SymmetricRandomWalkProposal",
    "propose", "propose_initial", "q", "logratio_proposal_density",
    # samplers
    "MetropolisHastings", "StaticMH", "RWMH", "Transition",
    "getparams", "setparams",
    # runtime
    "sample", "Schedule", "SamplingResult",
    "MCMCSerial", "MCMCThreads", "MCMCDistributed",
    # output / diagnostics
    "Chains", "StructArray", "chainscat", "ess", "ess_bulk", "ess_tail",
    "rhat", "rhat_rank", "mcse",
]
