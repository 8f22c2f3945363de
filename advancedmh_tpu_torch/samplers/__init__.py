from .adapt import StepSizeAdaptation, StepSizeAdaptationState, optimal_rwmh_accept
from .am import AdaptiveMetropolis, AdaptiveMetropolisState
from .barker import Barker
from .base import (
    GradientTransition,
    Sampler,
    Transition,
    accept_reject,
    getparams,
    select_tree,
    setparams,
)
from .chees import ChEESHMC, ChEESHMCState
from .demc import DifferentialEvolution
from .dr import DelayedRejection
from .dram import DRAM
from .emcee import Ensemble, StretchProposal, WalkProposal
from .ess import EllipticalSlice
from .hmc import HamiltonianMC
from .hmc_adapt import AdaptiveHMC, AdaptiveHMCState
from .mala import MALA
from .meads import MEADS, MEADSState
from .mh import RWMH, MetropolisHastings, StaticMH
from .mtm import MultipleTryMetropolis
from .pcn import PreconditionedCrankNicolson
from .ram import RobustAdaptiveMetropolis, RobustAdaptiveMetropolisState
from .slice import SliceSampler
from .tempering import ReplicaExchange, ReplicaExchangeState, swap_rates, tune_betas

__all__ = [
    "Sampler", "Transition", "GradientTransition", "accept_reject",
    "getparams", "select_tree", "setparams", "RWMH", "MetropolisHastings",
    "StaticMH", "MALA", "RobustAdaptiveMetropolis",
    "RobustAdaptiveMetropolisState", "Ensemble", "StretchProposal",
    "WalkProposal", "HamiltonianMC", "AdaptiveHMC", "AdaptiveHMCState",
    "StepSizeAdaptation", "StepSizeAdaptationState", "optimal_rwmh_accept",
    "ChEESHMC", "ChEESHMCState", "MEADS", "MEADSState", "Barker", "EllipticalSlice",
    "PreconditionedCrankNicolson", "SliceSampler", "AdaptiveMetropolis",
    "AdaptiveMetropolisState", "DelayedRejection", "DRAM", "MultipleTryMetropolis",
    "ReplicaExchange", "ReplicaExchangeState", "swap_rates", "tune_betas",
    "DifferentialEvolution",
]
