from .base import (
    Sampler,
    Transition,
    accept_reject,
    getparams,
    select_tree,
    setparams,
)
from .mh import RWMH, MetropolisHastings, StaticMH

__all__ = [
    "Sampler", "Transition", "accept_reject", "getparams", "select_tree",
    "setparams", "RWMH", "MetropolisHastings", "StaticMH",
]
