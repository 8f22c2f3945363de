from .adapt import StepSizeAdaptation, StepSizeAdaptationState, optimal_rwmh_accept
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
from .emcee import Ensemble, StretchProposal, WalkProposal
from .hmc import HamiltonianMC
from .hmc_adapt import AdaptiveHMC, AdaptiveHMCState
from .mala import MALA
from .meads import MEADS, MEADSState
from .mh import RWMH, MetropolisHastings, StaticMH
from .ram import RobustAdaptiveMetropolis, RobustAdaptiveMetropolisState

__all__ = [
    "Sampler", "Transition", "GradientTransition", "accept_reject",
    "getparams", "select_tree", "setparams", "RWMH", "MetropolisHastings",
    "StaticMH", "MALA", "RobustAdaptiveMetropolis",
    "RobustAdaptiveMetropolisState", "Ensemble", "StretchProposal",
    "WalkProposal", "HamiltonianMC", "AdaptiveHMC", "AdaptiveHMCState",
    "StepSizeAdaptation", "StepSizeAdaptationState", "optimal_rwmh_accept",
    "ChEESHMC", "ChEESHMCState", "MEADS", "MEADSState",
]
