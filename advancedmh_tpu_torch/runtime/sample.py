"""The sampling runtime (≙ advancedmh_tpu/runtime/sample.py).

Two engines:

- ``engine="torch"`` (default; ≙ the JAX package's ``"xla"``): a Python loop
  over steps with the chains as a batch dimension of every tensor, on the
  model's device.
- ``engine="fused"``: RWMH, Langevin MALA, RAM, the emcee stretch move,
  dual-averaging RWMH (``StepSizeAdaptation.rwmh``), HMC, AdaptiveHMC,
  ChEES-HMC, MEADS, slice sampling, elliptical slice sampling, the Barker
  proposal, pCN, Adaptive Metropolis, delayed rejection, DRAM,
  Multiple-Try Metropolis, replica exchange and DE-MC on the hand-written
  CUDA kernels (runtime/fused.py; on CPU tensors their plain
  PyTorch versions).

RNG: step ``j`` of a run draws from ``step_generator(master, j)`` (init is
``j = 0``; a resumed run adds ``iteration_offset``), so the draws depend on
the absolute iteration and not on how a run is split.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..models.density import as_model
from ..samplers.base import Sampler
from ..utils.keys import as_key, fold_in, step_generator
from ..utils.tree import tree_flatten, tree_map
from .schedule import Schedule


# --- chain-parallel execution strategies (≙ AbstractMCMC ensembles) ---------


@dataclasses.dataclass(frozen=True)
class MCMCSerial:
    """≙ AbstractMCMC.MCMCSerial: chains run one after another, chain c from
    the key ``fold_in(key, c)`` (debug aid)."""


@dataclasses.dataclass(frozen=True)
class MCMCThreads:
    """≙ AbstractMCMC.MCMCThreads: the chains are one batch dimension on the
    model's device."""


@dataclasses.dataclass(frozen=True)
class MCMCDistributed:
    """≙ AbstractMCMC.MCMCDistributed. Not ported yet: raises."""

    mesh: Optional[Any] = None
    axis: str = "chains"


ChainMethod = Union[str, MCMCSerial, MCMCThreads, MCMCDistributed, None]


def _resolve_chain_method(method: ChainMethod) -> str:
    if method is None or method == "vmap" or isinstance(method, MCMCThreads):
        return "batched"
    if method == "sequential" or isinstance(method, MCMCSerial):
        return "sequential"
    if isinstance(method, MCMCDistributed) or method == "shard_map":
        raise NotImplementedError(
            "MCMCDistributed is not ported to advancedmh_tpu_torch yet: "
            "multi-GPU sampling is the torch.distributed item of ROADMAP.md "
            "(Queue 1, slice 6); use MCMCThreads() on one GPU."
        )
    raise ValueError(f"Unknown chain method: {method!r}")


# --- tree helpers over transitions -------------------------------------------


def _stack(items: list, dim: int):
    """Stack a list of equal-structure transitions / trees along ``dim``."""
    first = items[0]
    if first is None:  # an optional state field left empty
        return None
    if dataclasses.is_dataclass(first):
        return type(first)(**{
            f.name: _stack([getattr(i, f.name) for i in items], dim)
            for f in dataclasses.fields(first)
        })
    if isinstance(first, tuple) and not hasattr(first, "_fields"):
        return tuple(_stack([i[k] for i in items], dim) for k in range(len(first)))
    leaves0, unflatten = tree_flatten(first)
    per = [tree_flatten(i)[0] for i in items]
    return unflatten([torch.stack([p[k] for p in per], dim) for k in range(len(leaves0))])


def _index(obj, c: int):
    """Chain ``c`` of a chain-batched transition / tree."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{
            f.name: _index(getattr(obj, f.name), c) for f in dataclasses.fields(obj)
        })
    return tree_map(lambda x: x[c], obj)


# --- the chain loop -----------------------------------------------------------


def build_chain_fn(
    sampler: Sampler,
    model,
    schedule: Schedule,
    collect_states: bool = False,
    from_state: bool = False,
    iteration_offset: int = 0,
    batch_shape: Optional[Tuple[int, ...]] = None,
    init_batched: bool = False,
):
    """Build ``chain_fn(master_key[, arg]) -> (samples, final_state)``.

    ``arg`` is the initial params (or, with ``from_state``, a state to
    continue from). With ``batch_shape`` the state carries a chain batch,
    each step is ``sampler.step_batched`` and the samples come back as
    ``(chains, n_samples, ...)``; without it, as ``(n_samples, ...)``.
    Sample 1 is the state after ``discard_initial`` steps, then one every
    ``thinning`` steps; steps ``t <= num_warmup`` use the warmup step.
    """
    model = as_model(model)
    W, D, th = schedule.num_warmup, schedule.discard_initial, schedule.thinning
    T = schedule.total_steps
    vector = batch_shape is not None
    device = model.device

    def step(gen, state, warmup: bool):
        if vector:
            fn = sampler.step_warmup_batched if warmup else sampler.step_batched
            return fn(gen, state, model, batch_shape)[1]
        fn = sampler.step_warmup if warmup else sampler.step
        return fn(gen, state, model)[1]

    def emit(state):
        t = sampler.transition_of(state)
        return (t, state) if collect_states else t

    def chain_fn(master: int, arg=None):
        init_gen = step_generator(master, 0, device)
        if from_state:
            state = arg
        elif vector:
            _, state = sampler.init_batched(init_gen, model, batch_shape, arg, init_batched)
        else:
            _, state = sampler.init(init_gen, model, arg)
        out = [emit(state)] if D == 0 else []
        for t in range(1, T + 1):
            gen = step_generator(master, iteration_offset + t, device)
            state = step(gen, state, sampler.has_warmup_phase and t <= W)
            if t >= D and (t - D) % th == 0:
                out.append(emit(state))
        return _stack(out, 1 if vector else 0), state

    return chain_fn


# --- result container -------------------------------------------------------


@dataclasses.dataclass
class SamplingResult:
    """Raw sampling output: ``transitions`` has leaves of shape
    ``(n_samples, ...)`` (single chain) or ``(num_chains, n_samples, ...)``."""

    transitions: Any
    final_state: Any
    schedule: Schedule
    num_chains: Optional[int]
    states: Any = None
    sampler: Any = None

    def to_chains(self, param_names=None):
        from ..output.bundle import bundle_chains

        return bundle_chains(self, param_names=param_names)

    def to_structarray(self, param_names=None):
        from ..output.bundle import bundle_structarray

        return bundle_structarray(self, param_names=param_names)

    def to_namedtuples(self, param_names=None):
        from ..output.bundle import bundle_namedtuples

        return bundle_namedtuples(self, param_names=param_names)


# --- public front-end -------------------------------------------------------


def _on_device(tree, device):
    """Initial params as float32 tensors on ``device``; a flat list of
    numbers is one vector, as ``jnp.asarray`` would make it."""
    if isinstance(tree, (list, tuple)) and all(
        isinstance(v, (int, float, np.number)) for v in tree
    ):
        tree = np.asarray(tree, np.float32)
    return tree_map(
        lambda x: torch.as_tensor(x, dtype=torch.float32).to(device), tree
    )


def sample(
    model,
    sampler: Sampler,
    n_samples,
    *args,
    key: int = 0,
    num_chains: Optional[int] = None,
    chain_method: ChainMethod = None,
    initial_params: Any = None,
    initial_params_batched: bool = False,
    initial_state: Any = None,
    iteration_offset: int = 0,
    num_warmup: int = 0,
    discard_initial: Optional[int] = None,
    thinning: int = 1,
    collect_states: bool = False,
    chain_type: Optional[str] = None,
    param_names=None,
    engine: str = "torch",
):
    """Draw ``n_samples`` per chain (≙ AbstractMCMC ``sample``; see
    runtime/schedule.py for the iteration contract).

    ``num_chains=None`` runs one chain with no chain axis. ``chain_type`` ∈
    {None, "chains", "structarray", "namedtuples"} selects the output bundle.
    ``initial_state`` + ``iteration_offset`` continue an earlier run
    bit-exactly (both engines).
    """
    # Positional ensemble form ≙ sample(model, spl, MCMCThreads(), N, nchains)
    if isinstance(n_samples, (MCMCSerial, MCMCThreads, MCMCDistributed)):
        chain_method = n_samples
        if not args:
            raise TypeError("sample(model, sampler, MCMC*(), N[, nchains]) needs N")
        n_samples = args[0]
        if len(args) > 1:
            num_chains = args[1]
        args = ()
    if args:
        raise TypeError(f"unexpected positional arguments: {args!r}")

    if engine == "xla":
        raise ValueError(
            "engine='xla' belongs to the JAX package; advancedmh_tpu_torch "
            "runs engine='torch' (the batched tensor loop) or engine='fused'"
        )
    if engine not in ("torch", "fused"):
        raise ValueError(f"Unknown engine: {engine!r}")
    model = as_model(model)
    schedule = Schedule(
        n_samples=n_samples,
        num_warmup=num_warmup,
        discard_initial=discard_initial,
        thinning=thinning,
    )
    master = as_key(key)
    method = _resolve_chain_method(chain_method)
    if initial_params is not None:
        initial_params = _on_device(initial_params, model.device)

    if engine == "fused":
        from ..samplers.adapt import StepSizeAdaptation
        from ..samplers.am import AdaptiveMetropolis
        from ..samplers.barker import Barker
        from ..samplers.chees import ChEESHMC
        from ..samplers.demc import DifferentialEvolution
        from ..samplers.dr import DelayedRejection
        from ..samplers.dram import DRAM
        from ..samplers.emcee import Ensemble
        from ..samplers.ess import EllipticalSlice
        from ..samplers.hmc import HamiltonianMC
        from ..samplers.hmc_adapt import AdaptiveHMC
        from ..samplers.mala import MALA
        from ..samplers.meads import MEADS
        from ..samplers.mtm import MultipleTryMetropolis
        from ..samplers.pcn import PreconditionedCrankNicolson
        from ..samplers.ram import RobustAdaptiveMetropolis
        from ..samplers.slice import SliceSampler
        from ..samplers.tempering import ReplicaExchange
        from .fused import (sample_fused, sample_fused_adapt_rwmh,
                            sample_fused_adaptive_hmc, sample_fused_am, sample_fused_barker,
                            sample_fused_chees, sample_fused_demc, sample_fused_emcee,
                            sample_fused_ess, sample_fused_hmc, sample_fused_mala,
                            sample_fused_meads, sample_fused_pcn, sample_fused_ram,
                            sample_fused_slice, sample_fused_tempering)

        # samplers that resume from their own state (its lp, and what else
        # the kernel carries) through initial_state
        own_start = {Barker: sample_fused_barker, PreconditionedCrankNicolson: sample_fused_pcn,
                     EllipticalSlice: sample_fused_ess, SliceSampler: sample_fused_slice,
                     AdaptiveMetropolis: sample_fused_am, DRAM: sample_fused_am,
                     DelayedRejection: sample_fused, MultipleTryMetropolis: sample_fused,
                     ReplicaExchange: sample_fused_tempering}

        if collect_states:
            raise ValueError(
                "engine='fused' does not collect per-step states; use "
                "engine='torch' for collect_states=True."
            )
        resume_S = resume_adapt = None
        if initial_state is not None:
            if isinstance(sampler, RobustAdaptiveMetropolis):
                initial_params, resume_S = initial_state.x, initial_state.S
            elif isinstance(sampler, (StepSizeAdaptation, AdaptiveHMC, ChEESHMC, MEADS,
                                      *own_start)):
                # frozen continuation: the saved per-chain ε̄ (and M⁻¹), the
                # ChEES statistics or MEADS's persistent (p, u, iteration) go
                # back into the kernels; the slice samplers, Barker, pCN and
                # DR and MTM take the state's own lp (and gradient), AM and
                # DRAM their live moments too and replica exchange its whole
                # ladder, so that a split run stays exact
                resume_adapt = initial_state
            elif isinstance(sampler, DifferentialEvolution):
                resume_adapt = initial_state  # the population and its own lp
            else:
                initial_params = initial_state.params
        common = dict(key=master, initial_params=initial_params,
                      discard_initial=schedule.discard_initial,
                      thinning=schedule.thinning,
                      iteration_offset=iteration_offset)
        if isinstance(sampler, Ensemble):  # the walkers are the batch axis
            transitions, final_state = sample_fused_emcee(
                model, sampler, schedule.n_samples, **common)
            return _finish(transitions, final_state, schedule, None, False,
                           sampler, chain_type, param_names)
        if isinstance(sampler, DifferentialEvolution):  # the members are the batch axis
            transitions, final_state = sample_fused_demc(
                model, sampler, schedule.n_samples, initial_state=resume_adapt, **common)
            return _finish(transitions, final_state, schedule, None, False,
                           sampler, chain_type, param_names)
        if num_chains is None:
            raise ValueError("engine='fused' requires num_chains")
        warm = dict(num_warmup=schedule.num_warmup, initial_state=resume_adapt)
        if type(sampler) in own_start:
            transitions, final_state = own_start[type(sampler)](
                model, sampler, schedule.n_samples, num_chains=num_chains,
                initial_state=resume_adapt, **common)
        elif isinstance(sampler, MEADS):
            transitions, final_state = sample_fused_meads(
                model, sampler, schedule.n_samples, num_chains=num_chains,
                initial_state=resume_adapt, **common)
        elif isinstance(sampler, ChEESHMC):
            transitions, final_state = sample_fused_chees(
                model, sampler, schedule.n_samples, num_chains=num_chains, **warm, **common)
        elif isinstance(sampler, StepSizeAdaptation):
            transitions, final_state = sample_fused_adapt_rwmh(
                model, sampler, schedule.n_samples, num_chains=num_chains, **warm, **common)
        elif isinstance(sampler, AdaptiveHMC):
            transitions, final_state = sample_fused_adaptive_hmc(
                model, sampler, schedule.n_samples, num_chains=num_chains, **warm, **common)
        elif isinstance(sampler, HamiltonianMC):
            transitions, final_state = sample_fused_hmc(
                model, sampler, schedule.n_samples, num_chains=num_chains, **common)
        elif isinstance(sampler, RobustAdaptiveMetropolis):
            transitions, final_state = sample_fused_ram(
                model, sampler, schedule.n_samples, num_chains=num_chains,
                num_warmup=schedule.num_warmup, initial_S=resume_S, **common)
        elif isinstance(sampler, MALA):
            transitions, final_state = sample_fused_mala(
                model, sampler, schedule.n_samples, num_chains=num_chains, **common)
        else:
            transitions, final_state = sample_fused(
                model, sampler, schedule.n_samples, num_chains=num_chains, **common)
        return _finish(transitions, final_state, schedule, num_chains, False,
                       sampler, chain_type, param_names)

    from_state = initial_state is not None
    if from_state:
        initial_params = initial_state
        initial_params_batched = True

    if num_chains is None:
        chain_fn = build_chain_fn(sampler, model, schedule, collect_states,
                                  from_state=from_state,
                                  iteration_offset=iteration_offset)
        out, final_state = chain_fn(master, initial_params)
    elif method == "sequential" or sampler.is_population:
        # a population sampler's state is a whole ensemble: chains of
        # ensembles run one after another
        chain_fn = build_chain_fn(sampler, model, schedule, collect_states,
                                  from_state=from_state,
                                  iteration_offset=iteration_offset)
        results = []
        for c in range(num_chains):
            arg = initial_params
            if arg is not None and initial_params_batched:
                arg = _index(arg, c)
            results.append(chain_fn(fold_in(master, c), arg))
        out = _stack([r[0] for r in results], 0)
        final_state = _stack([r[1] for r in results], 0)
    else:
        chain_fn = build_chain_fn(
            sampler, model, schedule, collect_states, from_state=from_state,
            iteration_offset=iteration_offset, batch_shape=(num_chains,),
            init_batched=initial_params_batched,
        )
        out, final_state = chain_fn(master, initial_params)
    return _finish(out, final_state, schedule, num_chains, collect_states,
                   sampler, chain_type, param_names)


def _finish(out, final_state, schedule, num_chains, collect_states, sampler,
            chain_type, param_names):
    transitions, states = out if collect_states else (out, None)
    result = SamplingResult(
        transitions=transitions,
        final_state=final_state,
        schedule=schedule,
        num_chains=num_chains,
        states=states,
        sampler=sampler,
    )
    return _convert(result, chain_type, param_names)


def _convert(result: SamplingResult, chain_type, param_names):
    if chain_type in (None, "raw"):
        return result
    if chain_type == "chains":
        return result.to_chains(param_names=param_names)
    if chain_type == "structarray":
        return result.to_structarray(param_names=param_names)
    if chain_type in ("namedtuples", "vector_of_namedtuples"):
        return result.to_namedtuples(param_names=param_names)
    raise ValueError(f"Unknown chain_type: {chain_type!r}")
