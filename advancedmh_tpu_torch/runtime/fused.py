"""Fused-engine dispatch: ``sample(engine="fused")`` on the CUDA kernels.

≙ advancedmh_tpu/runtime/fused.py. :data:`RUNNERS` names the runner of each
sampler class whose kernels are ported (on CPU tensors each kernel's plain
PyTorch version runs instead); :func:`run` takes the entry of the most
specific class in the sampler's MRO, and every runner takes the same
arguments.

The model must name a CUDA density (``model.cuda_density``, with its plain
``tile_density``, ``tile_value_and_grad`` for the gradient samplers, and
``tile_consts``; see models/targets.py).

Schedule contract: sample k is the state after ``burn + (k+1)*thinning``
steps (``Schedule.burn``), identical to the standard schedule when
``discard_initial >= thinning`` (the init state is never emitted); for RAM
and the adaptive samplers, ``burn`` is the ``num_warmup`` adaptive steps, so
sample k is the state after ``num_warmup + (k+1)*thinning`` steps (a
one-draw offset from the standard schedule, as in the JAX package's fused
engines; ``Schedule.check_adaptive``). AM and DRAM adapt on every step and
never freeze, so they take the standard schedule and resume with their
moments. Step t of the run is absolute iteration ``iteration_offset + t``,
and its noise depends only on (seed, iteration, chain or walker), so a run
split at any point and resumed with ``initial_state`` and
``iteration_offset`` gives the same draws as an unsplit one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..distributions import MvNormal, Normal
from ..ops.adapt import fused_adapt_rwmh_sample
from ..ops.am import AmParams, fused_am_sample
from ..ops.barker import fused_barker_sample
from ..ops.chees import (CheesParams, fused_chees_frozen_sample, fused_chees_warmup_block,
                         halton_trips, vdc)
from ..ops.dr import fused_dr_sample
from ..ops.demc import DemcParams, check_members, fused_demc_sample
from ..ops.dram import DramParams, fused_dram_sample
from ..ops.emcee import check_walkers, fused_emcee_sample
from ..ops.ess import fused_ess_sample
from ..ops.hmc import fused_hmc_sample, minv_column
from ..ops.hmc_adapt import DualAveraging, fused_adaptive_hmc_sample
from ..ops.mala import fused_mala_sample
from ..ops.meads import MeadsParams, fused_meads_sample
from ..ops.mtm import fused_mtm_sample
from ..ops.pcn import fused_pcn_sample
from ..ops.ram import RamParams, fused_ram_sample
from ..ops.rwmh import fused_rwmh_sample
from ..ops.slice import fused_slice_sample
from ..ops.tempering import fused_tempering_sample
from ..proposals import RandomWalkProposal, is_proposal
from ..samplers.adapt import StepSizeAdaptation, StepSizeAdaptationState
from ..samplers.am import AdaptiveMetropolis, AdaptiveMetropolisState
from ..samplers.barker import Barker
from ..samplers.base import GradientTransition, Transition
from ..samplers.chees import ChEESHMC, ChEESHMCState
from ..samplers.demc import DifferentialEvolution
from ..samplers.dr import DelayedRejection
from ..samplers.dram import DRAM
from ..samplers.emcee import Ensemble, StretchProposal
from ..samplers.ess import EllipticalSlice
from ..samplers.hmc import HamiltonianMC
from ..samplers.hmc_adapt import AdaptiveHMC, AdaptiveHMCState
from ..samplers.mala import MALA
from ..samplers.meads import MEADS, MEADSState
from ..samplers.mh import MetropolisHastings
from ..samplers.mtm import MultipleTryMetropolis
from ..samplers.pcn import PreconditionedCrankNicolson
from ..samplers.ram import RobustAdaptiveMetropolis, RobustAdaptiveMetropolisState
from ..samplers.slice import SliceSampler
from ..samplers.tempering import ReplicaExchange, ReplicaExchangeState
from ..utils.keys import fold_in, splitmix64, step_generator
from ..utils.trace import host_sync, span, traced
from ..utils.tree import tree_flatten
from .schedule import Schedule


def _not_ported(what: str) -> str:
    """The one error of a sampler, or a form of one, that no kernel runs."""
    names = ", ".join(cls.__name__ for cls in RUNNERS)
    return (f"engine='fused' has no kernel for this sampler: {what}; use engine='torch'. "
            f"The fused engine runs {names}.")


def _numpy(v, site: str) -> np.ndarray:
    """``v`` as a host array; a tensor's read is a host sync at ``site``."""
    if isinstance(v, torch.Tensor):
        return host_sync(site, lambda: v.detach().cpu().numpy())
    return np.asarray(v)


def _extract_rw_scale(sampler, d: int) -> np.ndarray:
    """The proposal scale, per-dimension ``(d,)`` or lower Cholesky
    ``(d, d)``; raises unless the sampler is a symmetric Gaussian RW."""
    if not isinstance(sampler, MetropolisHastings):
        raise ValueError(_not_ported(f"got {type(sampler).__name__}"))
    return _rw_leaf_scale(sampler.proposal, d)


def _rw_leaf_scale(p, d: int) -> np.ndarray:
    """Scale of a single zero-mean Gaussian RandomWalkProposal leaf."""
    if not is_proposal(p) or not isinstance(p, RandomWalkProposal):
        raise ValueError(_not_ported("the proposal is not a single RandomWalkProposal leaf"))
    payload = p.payload
    if isinstance(payload, (MvNormal, Normal)):
        if not np.allclose(_numpy(payload.loc, "proposal"), 0.0):
            raise ValueError(_not_ported("the increment is not zero-mean"))
        if isinstance(payload, MvNormal) and payload.scale_tril is not None:
            return np.tril(_numpy(payload.scale_tril, "proposal").astype(np.float32))
        if isinstance(payload, MvNormal) and payload.scale_diag is not None:
            return np.broadcast_to(_numpy(payload.scale_diag, "proposal"), (d,))
        return np.broadcast_to(_numpy(payload.scale, "proposal"), (d,))
    raise ValueError(_not_ported(f"payload {type(payload).__name__} is not Normal or MvNormal"))


def _rw_scale_on_device(sampler, d: int, device) -> torch.Tensor:
    """:func:`_extract_rw_scale` copied to ``device`` (a blocking copy)."""
    return host_sync("scale", torch.as_tensor, np.ascontiguousarray(_extract_rw_scale(sampler, d)),
                     dtype=torch.float32, device=device)


def fused_seed(master: int) -> int:
    """The kernels' 64-bit Philox seed for a master key."""
    return splitmix64(master)


def _tile(model, attr: str = "tile_density"):
    """The model's plain tile function ``attr`` and its constants."""
    fn = getattr(model, attr, None)
    if fn is None:
        raise ValueError(
            f"engine='fused' needs a model with a {attr} and a CUDA density "
            "tag (a TileDensityModel of models/targets.py); use engine='torch' "
            "for any other density"
        )
    return fn, tuple(model.tile_consts)


def _block_of(model, initial_params, num_chains: int):
    """Initial params as the kernels' (d, C) block on the model's device:
    one point broadcast to every chain, or one row per chain."""
    if initial_params is None:
        raise ValueError("engine='fused' requires initial_params: please specify initial "
                         "parameters")
    init = torch.as_tensor(initial_params, dtype=torch.float32).to(model.device)
    d = model.dimension if model.dimension is not None else int(init.shape[-1])
    if init.ndim == 1:
        return init[:, None].expand(d, num_chains).contiguous()
    return init.T.contiguous()


_chain_block = traced("fused.start")(_block_of)


def _layout(samples, lps, accs):
    """(N, d, C), (N, 1, C) → (C, N, d), (C, N), (C, N) bool. Views:
    bundling into Chains permutes back to the kernel's contiguous layout."""
    return samples.permute(2, 0, 1), lps[:, 0, :].T, accs[:, 0, :].T > 0.5


_chains_layout = traced("fused.layout")(_layout)


def _emission(schedule: Schedule, iteration_offset: int) -> dict:
    """The kernels' burn-in and emission arguments for ``schedule``."""
    return dict(burn=schedule.burn, thin=schedule.thinning, n_samples=schedule.n_samples,
                iteration_offset=iteration_offset)


def _start_params(initial_params, initial_state):
    """A resumed state's params in place of ``initial_params``, for the
    kernels that resume from the params alone (their lp from the tile
    density)."""
    return initial_params if initial_state is None else initial_state.params


def sample_fused(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused RWMH kernel (≙ the JAX ``sample_fused``) for a
    ``MetropolisHastings`` with one zero-mean Gaussian random-walk leaf;
    returns (transitions, final_state) in the standard (chains, samples,
    ...) layout. Every runner of :data:`RUNNERS` takes these arguments."""
    tile_fn, consts = _tile(model)
    params_t, lp0 = _start_block(model, num_chains, _start_params(initial_params, initial_state),
                                 None, tile_fn, consts)
    with span("fused.prepare"):
        scale = _rw_scale_on_device(sampler, params_t.shape[0], model.device)
    samples, lps, accs = fused_rwmh_sample(
        tile_fn, model.cuda_density, params_t, lp0, scale, consts, fused_seed(key),
        **_emission(schedule, iteration_offset))
    return _finish_plain(samples, lps, accs)


def sample_fused_dr(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused DR kernel (≙ the JAX ``sample_fused``'s DR branch): the
    stages' scales from their single Gaussian random-walk leaves, scalar or
    diagonal. ``initial_state`` (a final ``Transition``) resumes with its own
    lp, so that a split run stays exact."""
    tile_fn, consts = _tile(model)
    params_t, lp0 = _start_block(model, num_chains, initial_params, initial_state, tile_fn,
                                 consts)
    d = params_t.shape[0]
    # a full-covariance stage raises in ops/dr.py::stage_scales
    with span("fused.prepare"):
        s1, s2 = (host_sync("scale", torch.as_tensor,
                            np.array(_rw_leaf_scale(p, d), np.float32), device=model.device)
                  for p in (sampler.first, sampler.second))
    samples, lps, accs = fused_dr_sample(
        tile_fn, model.cuda_density, params_t, lp0, s1, s2, consts, fused_seed(key),
        **_emission(schedule, iteration_offset))
    return _finish_plain(samples, lps, accs)


def sample_fused_mtm(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused MTM kernel with the sampler's k; ``initial_state`` (a
    final ``Transition``) resumes with its own lp."""
    tile_fn, consts = _tile(model)
    params_t, lp0 = _start_block(model, num_chains, initial_params, initial_state, tile_fn,
                                 consts)
    with span("fused.prepare"):
        scale = _rw_scale_on_device(sampler, params_t.shape[0], model.device)
    samples, lps, accs = fused_mtm_sample(
        tile_fn, model.cuda_density, params_t, lp0, scale, consts, fused_seed(key),
        k=int(sampler.k), **_emission(schedule, iteration_offset))
    return _finish_plain(samples, lps, accs)


def sample_fused_mala(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused Langevin-MALA kernel (≙ JAX ``sample_fused_mala``).
    Needs ``MALA.langevin(step_size_sq)``: an arbitrary gradient → proposal
    function cannot be read. The final ``GradientTransition`` carries the
    gradient the kernel holds at the last draws."""
    s2 = getattr(sampler, "langevin_step_size_sq", None)
    if s2 is None:
        raise ValueError(
            "engine='fused' for MALA requires MALA.langevin(step_size_sq) "
            "(the canonical MvNormal(σ²/2 g, σ² I) proposal)."
        )
    initial_params = _start_params(initial_params, initial_state)
    if initial_params is None:
        raise ValueError("please specify initial parameters")
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    params_t = _chain_block(model, initial_params, num_chains)
    lp0, g0 = value_and_grad(params_t, *consts)
    samples, lps, accs, g_last = fused_mala_sample(
        value_and_grad, model.cuda_density, params_t, lp0, g0, consts,
        fused_seed(key), step_size_sq=s2, **_emission(schedule, iteration_offset))
    params, lp, accepted = _chains_layout(samples, lps, accs)
    final_state = GradientTransition(params[:, -1, :], lp[:, -1], g_last.T,
                                     accepted[:, -1])
    return Transition(params, lp, accepted), final_state


def _pooled_warmup(model, sampler, key: int, init: torch.Tensor,
                   num_warmup: int, iteration_offset: int):
    """Stage 1 of pooled RAM and pooled AdaptiveHMC: the pooled warmup on
    the torch engine (its reduction spans every chain), steps
    1..num_warmup drawn as ``sample(engine="torch")`` draws them."""
    C = init.shape[1]
    _, state = sampler.init_batched(step_generator(key, 0, model.device), model,
                                    (C,), init.T.contiguous(), True)
    for t in range(1, num_warmup + 1):
        gen = step_generator(key, iteration_offset + t, model.device)
        _, state = sampler.step_warmup_batched(gen, state, model, (C,))
    return state


def sample_fused_ram(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused RAM kernel (≙ JAX ``sample_fused_ram``): the adaptive
    warmup and the frozen-S draws in one launch. A resumed run (from a final
    state's x and S) continues frozen.

    ``pooled=True`` runs in two stages: the pooled warmup on the torch
    engine adapts one shared S, then the kernel runs frozen (warmup 0) from
    it. Post-warmup RAM never adapts, so the staging changes no algorithm."""
    initial_S = None
    if initial_state is not None:
        initial_params, initial_S = initial_state.x, initial_state.S
    schedule.check_adaptive("RAM", resume=initial_S is not None)
    num_warmup, thinning, n_samples = schedule.num_warmup, schedule.thinning, schedule.n_samples
    tile_fn, consts = _tile(model)
    params_t = _chain_block(model, initial_params, num_chains)
    d = params_t.shape[0]
    warmup, offset = num_warmup, iteration_offset
    if sampler.pooled and initial_S is None and num_warmup >= 1:
        state = _pooled_warmup(model, sampler, key, params_t, num_warmup,
                               iteration_offset)
        params_t = state.x.T.contiguous()
        lp0 = tile_fn(params_t, *consts)
        S0 = state.S[0].reshape(d * d, 1).expand(d * d, num_chains).contiguous()
        warmup, offset = 0, iteration_offset + num_warmup
    else:
        lp0 = tile_fn(params_t, *consts)
        if initial_S is not None:  # (C, d, d) per-chain factors
            S_in = torch.as_tensor(initial_S, dtype=torch.float32).to(model.device)
            if sampler.pooled:
                spread = float((S_in.amax(0) - S_in.amin(0)).max())
                if spread > 1e-5:
                    raise ValueError(
                        "fused pooled RAM resume needs the one shared S a "
                        "pooled warmup produces, but this state carries "
                        f"per-chain factors (spread {spread:.3g}); resume "
                        "with a pooled=False sampler or use engine='torch'."
                    )
            S0 = S_in.permute(1, 2, 0).reshape(d * d, num_chains).contiguous()
        else:
            S0 = sampler.initial_S(d, model.device).reshape(d * d, 1)
            S0 = S0.expand(d * d, num_chains).contiguous()
    samples, lps, accs, S_final = fused_ram_sample(
        tile_fn, model.cuda_density, params_t, lp0, S0, consts, fused_seed(key),
        warmup=warmup, thin=thinning, n_samples=n_samples,
        params=RamParams(sampler.alpha, sampler.gamma,
                         sampler.eigenvalue_lower_bound,
                         sampler.eigenvalue_upper_bound),
        iteration_offset=offset,
    )
    params, lp, accepted = _chains_layout(samples, lps, accs)
    C = num_chains
    zeros = torch.zeros((C,), dtype=torch.float32, device=model.device)
    final_state = RobustAdaptiveMetropolisState(
        x=params[:, -1, :], logprob=lp[:, -1],
        S=S_final.reshape(d, d, C).permute(2, 0, 1),
        logalpha=zeros, eta=zeros,
        iteration=torch.full((C,), iteration_offset + num_warmup
                             + n_samples * thinning + 1,
                             dtype=torch.int32, device=model.device),
        isaccept=accepted[:, -1],
    )
    return Transition(params, lp, accepted), final_state


def sample_fused_emcee(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: Optional[int] = None,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused emcee kernel (≙ JAX ``sample_fused_emcee``) on one
    ensemble of all W walkers (any even W). Without ``initial_params`` the
    walkers are drawn from the proposal's payload, as
    ``sample(engine="torch")`` draws them. Returns walker-layout
    transitions: params (N, W, d), lp and accepted (N, W). ``num_chains`` is
    unused: the walkers are the batch axis."""
    if not isinstance(sampler.proposal, StretchProposal):
        raise NotImplementedError(
            "engine='fused' emcee supports StretchProposal only; the walk "
            "move needs O(n_walkers) fresh normals per walker-step (use "
            "engine='torch')"
        )
    W = sampler.n_walkers
    check_walkers(W, W)
    tile_fn, consts = _tile(model)
    initial_params = _start_params(initial_params, initial_state)
    if initial_params is None:
        init_tr, _ = sampler.init(step_generator(key, 0, model.device), model)
        initial_params = init_tr.params
    x = torch.as_tensor(initial_params, dtype=torch.float32).to(model.device)
    if x.shape[0] != W:
        raise ValueError(
            f"initial_params carries {x.shape[0]} walkers but the Ensemble "
            f"was built with n_walkers={W}"
        )
    params_t = x.reshape(W, -1).T.contiguous()
    lp0 = tile_fn(params_t, *consts)
    samples, lps, accs = fused_emcee_sample(
        tile_fn, model.cuda_density, params_t, lp0, consts, fused_seed(key),
        stretch_length=sampler.proposal.stretch_length, tile_walkers=W,
        **_emission(schedule, iteration_offset))
    params = samples.permute(0, 2, 1)  # (N, W, d)
    lp, accepted = lps[:, 0, :], accs[:, 0, :] > 0.5
    return (Transition(params, lp, accepted),
            Transition(params[-1], lp[-1], accepted[-1]))


def sample_fused_am(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused Adaptive Metropolis, and DRAM on its own kernel (≙ the JAX
    ``sample_fused_am``): adaptation runs on every step, burn-in and
    emission alike, so a resumed ``initial_state`` (an
    ``AdaptiveMetropolisState``) carries x, its own logprob, mean, L and
    iteration straight back into the kernel. A fresh start has mean₀ = x₀,
    L₀ = (fixed_scale/√d)·I and n₀ = 1. The final state's ``iteration`` is
    the kernel's count, 1 + burn + n_samples·thinning for a fresh run.

    ``pooled=True`` raises, as in JAX: the shared covariance keeps adapting
    on every step, so there is no frozen stage to put on a per-chain kernel;
    the torch engine runs the pooled merge exactly."""
    if sampler.pooled:
        raise ValueError(
            "engine='fused' does not support pooled "
            f"{type(sampler).__name__}: pooled AM/DRAM keep adapting the "
            "ONE shared covariance on every post-warmup step (the AM "
            "ergodicity contract), and that cross-chain Welford merge "
            "spans kernel tiles - there is no frozen stage to stage "
            "(unlike pooled RAM, whose S freezes after warmup). Use "
            "engine='torch', which runs the pooled merge exactly."
        )
    tile_fn, consts = _tile(model)
    dev = model.device
    if initial_state is not None:
        st = initial_state
        x_t = st.x.to(dev).T.contiguous()
        d, C = x_t.shape
        lp0 = st.logprob.to(dev).reshape(1, C).contiguous()
        mean0 = st.mean.to(dev).T.contiguous()
        L0 = st.L.to(dev).permute(1, 2, 0).reshape(d * d, C).contiguous()
        n0 = st.iteration.to(dev).to(torch.float32).reshape(1, C).contiguous()
    else:
        x_t = _chain_block(model, initial_params, num_chains)
        d, C = x_t.shape
        lp0 = tile_fn(x_t, *consts)
        mean0 = x_t.clone()
        L0 = ((sampler.fixed_scale / math.sqrt(d)) * torch.eye(d, device=dev)).reshape(d * d, 1)
        L0 = L0.expand(d * d, C).contiguous()
        n0 = torch.ones((1, C), dtype=torch.float32, device=dev)
    if isinstance(sampler, DRAM):
        kernel, prm = fused_dram_sample, DramParams(sampler.opt_scale, sampler.gamma)
    else:
        kernel, prm = fused_am_sample, AmParams(sampler.beta, sampler.fixed_scale,
                                                sampler.opt_scale, sampler.adapt_start)
    samples, lps, accs, mean_f, L_f, n_f = kernel(
        tile_fn, model.cuda_density, x_t, lp0, mean0, L0, n0, consts, fused_seed(key),
        params=prm, **_emission(schedule, iteration_offset))
    params, lp, accepted = _chains_layout(samples, lps, accs)
    final_state = AdaptiveMetropolisState(
        x=params[:, -1, :], logprob=lp[:, -1], mean=mean_f.T,
        L=L_f.reshape(d, d, C).permute(2, 0, 1), iteration=n_f[0].to(torch.int32),
        isaccept=accepted[:, -1])
    return Transition(params, lp, accepted), final_state


# ---- the HMC family and dual-averaging RWMH ---------------------------------


def _dual_averaging(sampler) -> DualAveraging:
    return DualAveraging(sampler.initial_step_size, sampler.target_accept,
                         sampler.t0, sampler.kappa, sampler.gamma, sampler.mu)


def sample_fused_adapt_rwmh(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused dual-averaging kernel (≙ JAX ``sample_fused_adapt_rwmh``)
    for ``StepSizeAdaptation.rwmh``: the HG14 warmup and the frozen-ε̄ draws
    in one launch. ``initial_state`` (a final ``StepSizeAdaptationState``)
    resumes frozen on the resume variant of the kernel."""
    fam = getattr(sampler, "_fused_family", None)
    if not (isinstance(fam, tuple) and fam and fam[0] == "rwmh_iso"):
        raise ValueError(
            "engine='fused' for StepSizeAdaptation requires the "
            "StepSizeAdaptation.rwmh(d) family (general make_sampler "
            "closures cannot be introspected); use engine='torch' instead."
        )
    resume = initial_state is not None
    schedule.check_adaptive("StepSizeAdaptation", resume)
    num_warmup = schedule.num_warmup
    if initial_params is None and not resume:
        raise ValueError("engine='fused' requires initial_params")
    d = fam[1]
    tile_fn, consts = _tile(model)
    if resume:
        params_t = torch.as_tensor(initial_state.inner.params).to(model.device).T.contiguous()
        lp0 = initial_state.inner.lp.to(model.device).reshape(1, -1).contiguous()
        leb = initial_state.log_eps_bar.to(model.device).reshape(1, -1).contiguous()
    else:
        params_t = _chain_block(model, initial_params, num_chains)
        lp0 = tile_fn(params_t, *consts)
        leb = None
    if params_t.shape != (d, num_chains):
        raise ValueError(f"the state must be {num_chains} chains of the family's d={d}, "
                         f"got {tuple(params_t.T.shape)}")
    samples, lps, accs, leb_out = fused_adapt_rwmh_sample(
        tile_fn, model.cuda_density, params_t, lp0, consts, fused_seed(key),
        warmup=num_warmup, thin=schedule.thinning, n_samples=schedule.n_samples,
        da=_dual_averaging(sampler), log_eps_bar=leb, iteration_offset=iteration_offset,
    )
    params, lp, accepted = _chains_layout(samples, lps, accs)
    inner = Transition(params[:, -1, :], lp[:, -1], accepted[:, -1])
    if resume:  # frozen continuation: the saved statistics carry through
        return (Transition(params, lp, accepted),
                dataclasses.replace(initial_state, inner=inner))
    C = num_chains
    final_state = StepSizeAdaptationState(
        inner=inner, log_eps=leb_out[0], log_eps_bar=leb_out[0].clone(),
        h_bar=torch.zeros((C,), dtype=torch.float32, device=model.device),
        t=torch.full((C,), num_warmup + 1, dtype=torch.int32, device=model.device),
    )
    return Transition(params, lp, accepted), final_state


def _diagonal_inverse_mass(inverse_mass):
    """A sampler's inverse mass as the fused HMC kernel takes it: None, a
    scalar or a (d,) diagonal."""
    if inverse_mass is None:
        return None
    msg = ("engine='fused' HMC supports scalar/diagonal inverse_mass; "
           "pytree masses need engine='torch'.")
    if isinstance(inverse_mass, dict):
        raise ValueError(msg)
    try:
        m = np.asarray(_numpy(inverse_mass, "inverse_mass"), np.float32)
    except (TypeError, ValueError):
        raise ValueError(msg) from None
    if m.ndim > 1:
        raise ValueError(msg)
    return m


def sample_fused_hmc(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused HMC kernel (≙ JAX ``sample_fused_hmc``): whole
    leapfrog trajectories with the density's value and gradient in the
    kernel, scalar or diagonal ``inverse_mass``, endpoint accept. The final
    ``GradientTransition`` carries the kernel's gradient at the last draws."""
    initial_params = _start_params(initial_params, initial_state)
    if initial_params is None:
        raise ValueError("please specify initial parameters")
    if sampler.trajectory_sampling != "endpoint":
        raise ValueError(
            "engine='fused' HMC is endpoint-only; multinomial trajectory "
            "sampling runs on engine='torch'."
        )
    minv = _diagonal_inverse_mass(sampler.inverse_mass)
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    params_t = _chain_block(model, initial_params, num_chains)
    lp0, g0 = value_and_grad(params_t, *consts)
    samples, lps, accs, g_last = fused_hmc_sample(
        value_and_grad, model.cuda_density, params_t, lp0, g0, consts, fused_seed(key),
        step_size=float(sampler.step_size), n_leapfrog=int(sampler.n_leapfrog),
        inverse_mass=minv_column(minv, params_t.shape[0], model.device),
        **_emission(schedule, iteration_offset))
    params, lp, accepted = _chains_layout(samples, lps, accs)
    final_state = GradientTransition(params[:, -1, :], lp[:, -1], g_last.T, accepted[:, -1])
    return Transition(params, lp, accepted), final_state


def _pooled_stage(wstate: AdaptiveHMCState, d: int, num_chains: int):
    """The frozen launch of a pooled AdaptiveHMC state: the per-chain
    log ε̄ row (pooled AdaptiveHMC pools the mass but dual-averages ε per
    chain) and the one shared M⁻¹ broadcast to (d, C). Raises for a state
    whose mass was adapted per chain: the frozen phase would apply chain
    0's estimate to every chain."""
    leaves, _ = tree_flatten(wstate.inverse_mass)
    minv = leaves[0].to(torch.float32)
    if minv.ndim > 1:
        spread = float((minv.amax(0) - minv.amin(0)).max())
        if spread > 1e-5:
            raise ValueError(
                "fused pooled AdaptiveHMC needs a replicated (shared) "
                "inverse-mass estimate, but this state carries per-chain "
                f"values (spread {spread:.3g}) - it was warmed per-chain "
                "(pooled=False). Use engine='torch' for it."
            )
        minv = minv[0]
    leb = wstate.log_eps_bar.to(torch.float32).reshape(1, -1).contiguous()
    minv_block = minv.reshape(d, 1).expand(d, num_chains).contiguous()
    return leb, minv_block


def sample_fused_adaptive_hmc(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Run the fused AdaptiveHMC kernel (≙ JAX ``sample_fused_adaptive_hmc``).

    - Per chain: the joint (ε, diag M⁻¹) warmup and the frozen draws in one
      launch; ``initial_state`` resumes frozen on the kernel's resume
      variant.
    - ``pooled=True``: the pooled warmup (its Welford merge spans every
      chain) runs on the torch engine, steps 1..num_warmup drawn as
      ``sample(engine="torch")`` draws them; then the resume variant runs
      the frozen phase with each chain's ε̄ and the one shared M⁻¹. Frozen
      HMC at a constant leapfrog count is the function either way.

    A fresh per-chain final state supports frozen continuation only: the
    kernel keeps no Welford mean or error sum, so ``mean`` is the last
    position, ``h_bar`` 0, and M2 is the regularised estimate inverted at
    ``n = num_warmup`` (the JAX package's reconstruction)."""
    resume = initial_state is not None
    schedule.check_adaptive("AdaptiveHMC", resume)
    num_warmup = schedule.num_warmup
    if not resume:
        if num_warmup < 1:
            raise ValueError("fused AdaptiveHMC requires num_warmup >= 1")
        if initial_params is None:
            raise ValueError("please specify initial parameters")
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    C = num_chains
    kw = dict(n_leapfrog=int(sampler.n_leapfrog), thin=schedule.thinning,
              n_samples=schedule.n_samples,
              da=_dual_averaging(sampler), mass_regularization=sampler.mass_regularization,
              mass_warm_start=sampler.mass_warm_start)

    def launch(params_t, lp0, g0, warmup, offset, leb=None, minv=None):
        return fused_adaptive_hmc_sample(
            value_and_grad, model.cuda_density, params_t, lp0, g0, consts,
            fused_seed(key), warmup=warmup, log_eps_bar=leb, inverse_mass=minv,
            iteration_offset=offset, **kw)

    if sampler.pooled or resume:
        dev = model.device
        if resume:  # the state's own lp and gradient: a split run stays exact
            wstate, offset = initial_state, iteration_offset
            params_t = wstate.inner.params.to(dev).T.contiguous()
            lp0 = wstate.inner.lp.to(dev).reshape(1, -1).contiguous()
            g0 = wstate.inner.gradient.to(dev).T.contiguous()
        else:
            init = _chain_block(model, initial_params, C)
            wstate = _pooled_warmup(model, sampler, key, init, num_warmup, iteration_offset)
            offset = iteration_offset + num_warmup
            params_t = wstate.inner.params.T.contiguous()
            lp0, g0 = value_and_grad(params_t, *consts)
        d = params_t.shape[0]
        if sampler.pooled:
            leb, minv = _pooled_stage(wstate, d, C)
        else:
            leaves, _ = tree_flatten(wstate.inverse_mass)
            leb = wstate.log_eps_bar.to(torch.float32).reshape(1, -1).contiguous()
            minv = leaves[0].to(torch.float32).T.contiguous()
        samples, lps, accs, _, _, g_last = launch(params_t, lp0, g0, 0, offset,
                                                  leb.to(dev), minv.to(dev))
        params, lp, accepted = _chains_layout(samples, lps, accs)
        inner = GradientTransition(params[:, -1, :], lp[:, -1], g_last.T, accepted[:, -1])
        return Transition(params, lp, accepted), dataclasses.replace(wstate, inner=inner)

    params_t = _chain_block(model, initial_params, C)
    lp0, g0 = value_and_grad(params_t, *consts)
    samples, lps, accs, leb, minv, g_last = launch(params_t, lp0, g0, num_warmup,
                                                   iteration_offset)
    params, lp, accepted = _chains_layout(samples, lps, accs)
    inner = GradientTransition(params[:, -1, :], lp[:, -1], g_last.T, accepted[:, -1])
    inv_mass = minv.T.contiguous()  # (C, d)
    nn = float(max(num_warmup, 1))
    r = float(sampler.mass_regularization)
    var = (inv_mass - 1e-3 * (r / (nn + r))) * ((nn + r) / nn)
    m2 = torch.clamp(var, min=0.0) * max(nn - 1.0, 1.0)
    final_state = AdaptiveHMCState(
        inner=inner, log_eps=leb[0], log_eps_bar=leb[0].clone(),
        h_bar=torch.zeros((C,), dtype=torch.float32, device=model.device),
        t=torch.full((C,), num_warmup + 1, dtype=torch.int32, device=model.device),
        mean=inner.params, m2=m2,
        n=torch.full((C,), nn, dtype=torch.float32, device=model.device),
        inverse_mass=inv_mass,
    )
    return Transition(params, lp, accepted), final_state


# ---- ChEES-HMC and MEADS ------------------------------------------------------


def fused_tile(num_chains: int, max_tile: int, d: int, budget: int) -> int:
    """The JAX engines' pooling tile for ``num_chains`` chains on one device
    (≙ advancedmh_tpu/runtime/fused.py::_fused_tiling): the largest multiple
    of 128 up to ``max_tile`` that divides the chain count padded to 128,
    capped so that 32 draws of (d, tile) float32 fit in ``budget`` bytes.
    The tile sets how many chains each statistic pools over, so the port
    keeps the rule; it pads nothing, and a ragged last tile is short."""
    if max_tile < 128:
        raise ValueError(f"tile_chains must be >= 128, got {max_tile}")
    cap = max(128, budget // (32 * d * 4) // 128 * 128)
    k = -(-num_chains // 128)
    for t in range(min(k, min(max_tile, cap) // 128), 0, -1):
        if k % t == 0:
            return 128 * t
    raise AssertionError("unreachable: t = 1 divides k")


# The JAX engines' largest tiles and budgets: the ChEES warmup pools over
# 512 chains at d = 32, 1024 at d = 10, 4096 at d = 2; MEADS over 1024, 2048
# and 4096.
MAX_TILE = 4096
CHEES_WARMUP_BUDGET = 2 << 20
MEADS_BUDGET = 4 << 20


def chees_warmup_combine(sv_tiles, sum_x, sum_x2, x, lp, g, acc, minv0, *, m_obs: float,
                         adapt_mass: bool, reg: float, warm_start: float):
    """Merge the warmup's tiles (≙ runtime/fused.py::_chees_warmup_combine):
    the seven adapted scalars averaged over the tiles, the Welford moments
    merged exactly from the tiles' raw sums with the global count ``m_obs``.
    Returns the replicated ``ChEESHMCState`` and the packed sv (9, 1) and
    M⁻¹ (d, 1)."""
    d, C = x.shape
    scalars = torch.mean(sv_tiles[0:7], dim=1, keepdim=True)
    s1 = torch.sum(sum_x, dim=1, keepdim=True)
    s2 = torch.sum(sum_x2, dim=1, keepdim=True)
    mean = s1 / m_obs
    m2 = s2 - s1 * s1 / m_obs
    if adapt_mass and m_obs >= warm_start:
        var = m2 / max(m_obs - 1.0, 1.0)
        minv = (m_obs / (m_obs + reg)) * var + 1e-3 * (reg / (m_obs + reg))
    else:
        minv = minv0
    sv = torch.cat([scalars, sv_tiles[7:8, 0:1], torch.full_like(scalars[:1], m_obs)])
    row = lambda i: sv[i, 0].expand(C).clone()
    col = lambda a: a.T.expand(C, d).clone()
    state = ChEESHMCState(
        inner=GradientTransition(x.T, lp[0], g.T, acc[0] > 0.5),
        log_eps=row(0), log_eps_bar=row(1), h_bar=row(2), log_traj=row(3),
        log_traj_bar=row(4), adam_m=row(5), adam_v=row(6),
        t=sv[7, 0].to(torch.int32).expand(C).clone(), mean=col(mean), m2=col(m2), n=row(8),
        inverse_mass=col(minv))
    return state, sv, minv


def fused_chees_warmup(model, sampler, key: int, x_t, lp0, g_t, num_warmup: int, *,
                       iteration_offset: int = 0, attempts=None):
    """The fused ChEES warmup (≙ runtime/fused.py::fused_chees_warmup): the
    whole warmup in one launch, pooled over the JAX rule's tiles, then the
    tiles' combine. The trips are staged from the initial ratio T₀/ε₀ with
    van der Corput jitter of period ``e_w``, the largest divisor of
    ``num_warmup`` up to 16. If the adapted ratio T̄/ε̄ lands more than 3×
    off the staged one, the warmup runs again from the start, staged at the
    adapted ratio (at most 3 attempts), with the noise of another seed.
    ``attempts`` (a list) receives one entry per launch."""
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    d, C = x_t.shape
    tile = fused_tile(C, MAX_TILE, d, CHEES_WARMUP_BUDGET)
    sv = torch.zeros(9, dtype=torch.float32, device=x_t.device)
    sv[0] = sv[1] = math.log(sampler.initial_step_size)
    sv[3] = sv[4] = math.log(sampler.initial_trajectory_length)
    sv[7] = 1.0
    minv = torch.ones((d, 1), dtype=torch.float32, device=x_t.device)
    max_l = int(sampler.max_leapfrog)
    e_w = max(e for e in range(1, 17) if num_warmup % e == 0)
    us = tuple(vdc(j + 1) for j in range(e_w))
    ratio = sampler.initial_trajectory_length / sampler.initial_step_size
    prm = CheesParams.of(sampler)
    for attempt in range(3):
        trips = tuple(max(1, min(max_l, round(u * ratio))) for u in us)
        xo, lpo, go, acc, sv_tiles, sx, sx2 = fused_chees_warmup_block(
            value_and_grad, model.cuda_density, x_t, lp0, g_t, consts,
            fused_seed(fold_in(fold_in(key, 1), attempt)), trips=trips, us=us,
            n_groups=num_warmup // e_w, sv=sv, inverse_mass=minv, params=prm,
            tile_chains=tile, iteration_offset=iteration_offset)
        out = chees_warmup_combine(
            sv_tiles, sx, sx2, xo, lpo, go, acc, minv, m_obs=float(C * num_warmup),
            adapt_mass=bool(sampler.adapt_mass), reg=float(sampler.mass_regularization),
            warm_start=float(sampler.mass_warm_start))
        if attempts is not None:
            attempts.append(dict(trips=trips, tile=tile))
        ratio_hat = float(torch.exp(out[1][4, 0] - out[1][1, 0]))
        if ratio / 3.0 - 1.0 <= ratio_hat <= 3.0 * ratio + 1.0:
            break
        ratio = ratio_hat
    return out


def chees_frozen_stage(sampler, wstate: ChEESHMCState, d: int):
    """The frozen launch's inputs from a warmed state (≙
    runtime/fused.py::chees_frozen_stage): the ratio
    ``max(1, min(round(T̄/ε̄), max_leapfrog))`` in float64 on the host from
    the float32 ε̄ = exp(log ε̄) and T̄ = exp(log T̄), ε̄ (1,) and the M⁻¹
    column (d, 1). Raises for a state whose statistics are not replicated:
    the frozen kernel applies one (ε̄, T̄, M⁻¹) to every chain."""
    leb = wstate.log_eps_bar.to(torch.float32).reshape(-1)
    ltb = wstate.log_traj_bar.to(torch.float32).reshape(-1)
    leaves, _ = tree_flatten(wstate.inverse_mass)
    minv = leaves[0].to(torch.float32)
    spread = max(float(leb.max() - leb.min()), float(ltb.max() - ltb.min()))
    if minv.ndim > 1:
        spread = max(spread, float((minv.amax(0) - minv.amin(0)).max()))
    if spread > 1e-5:
        raise ValueError(
            "fused ChEESHMC needs replicated (shared) adaptation statistics, but this "
            f"state carries per-chain values (spread {spread:.3g}) - it was warmed by "
            "the per-chain fallback kernels (single-chain), not the batched pooled "
            "warmup. Use engine='torch' for it.")
    eps = torch.exp(leb[0:1])
    eps_bar, t_bar = float(eps[0]), float(torch.exp(ltb[0]))
    ratio = max(1, min(int(round(t_bar / eps_bar)), int(sampler.max_leapfrog)))
    minv_col = (minv[0] if minv.ndim > 1 else minv).reshape(d, 1).contiguous()
    return ratio, eps, minv_col


def sample_fused_chees(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
    warmup_engine: str = "fused",
    stage_clock=None,
):
    """Fused ChEES-HMC (≙ runtime/fused.py::sample_fused_chees), in two
    stages:

    1. the warmup: ``"fused"`` on the warmup kernel
       (:func:`fused_chees_warmup`, steps ``1..num_warmup``), ``"torch"`` on
       the torch engine (``step_warmup_batched`` over the whole batch, as
       ``sample(engine="torch")`` draws it);
    2. the frozen phase on the frozen kernel: (ε̄, T̄) staged on the host, the
       ratio R = round(T̄/ε̄) and the van der Corput schedule
       ``halton_trips(R, E·thinning)`` with E = min(16, n_samples). Frozen
       step j (absolute, ``num_warmup + 1`` the first of a fresh run) runs
       ``trips[(j − t_w) mod (E·thinning)]`` leapfrog steps, t_w = num_warmup
       + 1 the state's warmup counter, so a resumed run continues the
       schedule where the split left it.

    ``initial_state`` (a ``ChEESHMCState``, e.g. a ``final_state``) resumes
    frozen under the chunk-resume schedule; ``iteration_offset`` then counts the
    steps of the earlier calls, warmup included. The warmup noise comes from
    a seed derived from (key, attempt), the frozen noise from the key's, so
    a run split after its warmup and resumed equals the unsplit run bit for
    bit when both calls draw at least 16 samples. ``stage_clock`` (a dict)
    receives ``warmup_s`` (everything before the frozen launch),
    ``warmup_launch_s`` (the fused warmup's launches and their tile
    combines), ``sampling_s`` (the frozen launch), each fenced by a
    synchronize, and the launches' ``attempts``, ``ratio`` and ``trips``."""
    import time as _time

    schedule.check_adaptive("ChEESHMC", resume=initial_state is not None)
    num_warmup, thinning, n_samples = schedule.num_warmup, schedule.thinning, schedule.n_samples
    if initial_state is None:
        if num_warmup < 1:
            raise ValueError(
                "fused ChEESHMC requires num_warmup >= 1 (the engine exists to freeze "
                "the warmup-adapted (ε̄, T̄)).")
        if initial_params is None:
            raise ValueError("please specify initial parameters")
    if warmup_engine not in ("fused", "torch"):
        raise ValueError(f"unknown warmup_engine {warmup_engine!r}")
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    dev = model.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    t_start = _time.perf_counter()
    attempts, warmup_launch_s = [], 0.0
    if initial_state is not None:
        wstate, offset = initial_state, iteration_offset
        x_t = wstate.inner.params.to(dev).T.contiguous()
        lp0 = wstate.inner.lp.to(dev).reshape(1, -1).contiguous()
        g_t = wstate.inner.gradient.to(dev).T.contiguous()
        ratio, eps, minv = chees_frozen_stage(sampler, wstate, x_t.shape[0])
    else:
        x0 = _chain_block(model, initial_params, num_chains)
        offset = iteration_offset + num_warmup
        if warmup_engine == "torch":
            wstate = _pooled_warmup(model, sampler, key, x0, num_warmup, iteration_offset)
            x_t = wstate.inner.params.T.contiguous()
            lp0, g_t = value_and_grad(x_t, *consts)
            ratio, eps, minv = chees_frozen_stage(sampler, wstate, x_t.shape[0])
        else:
            lp00, g00 = value_and_grad(x0, *consts)
            sync()
            t_launch = _time.perf_counter()
            wstate, sv, minv = fused_chees_warmup(
                model, sampler, key, x0, lp00, g00, num_warmup,
                iteration_offset=iteration_offset, attempts=attempts)
            sync()
            warmup_launch_s = _time.perf_counter() - t_launch
            x_t = wstate.inner.params.T.contiguous()
            lp0 = wstate.inner.lp.reshape(1, -1).contiguous()
            g_t = wstate.inner.gradient.T.contiguous()
            eps = torch.exp(sv[1])  # the replicated scalars: no guard needed
            ratio = max(1, min(int(round(float(torch.exp(sv[4, 0])) / float(eps[0]))),
                               int(sampler.max_leapfrog)))
    E = min(16, n_samples)
    trips = halton_trips(ratio, E * thinning, sampler.max_leapfrog)
    t_w = int(wstate.t.reshape(-1)[0])
    sync()
    t_frozen = _time.perf_counter()
    samples, lps, accs, g_last = fused_chees_frozen_sample(
        value_and_grad, model.cuda_density, x_t, lp0, g_t, consts, fused_seed(key),
        trips=trips, phase=(offset + 1 - t_w) % len(trips), step_size=eps.reshape(1, 1),
        inverse_mass=minv, thin=thinning, n_samples=n_samples, iteration_offset=offset)
    if stage_clock is not None:
        sync()
        stage_clock.update(warmup_s=t_frozen - t_start, warmup_launch_s=warmup_launch_s,
                           sampling_s=_time.perf_counter() - t_frozen, attempts=attempts,
                           ratio=ratio, trips=trips)
    params, lp, accepted = _chains_layout(samples, lps, accs)
    inner = GradientTransition(params[:, -1, :], lp[:, -1], g_last.T, accepted[:, -1])
    return Transition(params, lp, accepted), dataclasses.replace(wstate, inner=inner)


def sample_fused_meads(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused MEADS (≙ runtime/fused.py::sample_fused_meads): the whole
    sampler in one launch, folds pooled within the JAX rule's tiles (a
    ragged last tile is short and pools over its own chains; every tile
    must split into n_folds folds of >= 2 chains).

    Iteration t of the kernel is ``t0 + s``: ``t0 = 1 + iteration_offset``
    fresh (the torch engine's 1-based ``state.iteration``) or the resumed
    state's ``iteration``; the persistent p and u of a fresh run are drawn
    as ``sample(engine="torch")`` draws them (generator of step 0). The
    kernel runs exactly ``burn + n_samples·thinning`` steps
    (``Schedule.burn``), and the final state's
    ``iteration`` is ``t0`` plus that count, so a run split anywhere and
    resumed from ``final_state`` equals the unsplit run bit for bit."""
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    dev = model.device
    if initial_state is not None:
        st = initial_state
        x_t = st.x.to(dev).T.contiguous()
        lp0 = st.lp.to(dev).reshape(1, -1).contiguous()
        g0 = st.grad.to(dev).T.contiguous()
        p0 = st.p.to(dev).T.contiguous()
        u0 = st.u.to(dev).reshape(1, -1).contiguous()
        t0 = int(st.iteration.reshape(-1)[0])
    else:
        if initial_params is None:
            raise ValueError("engine='fused' requires initial_params")
        x_t = _chain_block(model, initial_params, num_chains)
        lp0, g0 = value_and_grad(x_t, *consts)
        gen = step_generator(key, 0, dev)
        p0 = torch.randn(x_t.T.shape, generator=gen, device=dev).T.contiguous()
        u0 = torch.rand((num_chains,), generator=gen, device=dev).reshape(1, -1)
        t0 = 1 + int(iteration_offset)
    d, C = x_t.shape
    burn, thinning, n_samples = schedule.burn, schedule.thinning, schedule.n_samples
    samples, lps, accs, x_f, lp_f, g_f, p_f, u_f = fused_meads_sample(
        value_and_grad, model.cuda_density, x_t, lp0, g0, p0, u0, consts, fused_seed(key),
        n_folds=int(sampler.n_folds), t0=t0, burn=burn, thin=thinning, n_samples=n_samples,
        params=MeadsParams.of(sampler), tile_chains=fused_tile(C, MAX_TILE, d, MEADS_BUDGET))
    params, lp, accepted = _chains_layout(samples, lps, accs)
    final_state = MEADSState(
        x=x_f.T, lp=lp_f[0], grad=g_f.T, p=p_f.T, u=u_f[0],
        iteration=torch.full((C,), t0 + burn + n_samples * thinning, dtype=torch.int32,
                             device=dev),
        isaccept=accepted[:, -1])
    return Transition(params, lp, accepted), final_state


# ---- slice sampling, elliptical slice, Barker and pCN ------------------------------------

# The JAX engines' caps on the trip budgets (runtime/fused.py:1837, 1981-1982 of
# the JAX package): they decide when a chain reports accepted=False.
MAX_STEPOUT = 8
MAX_SHRINK = 24


def _extract_ess_prior(sampler, d: int):
    """(loc (d,), scale) of the sampler's Gaussian prior: a per-dimension
    std-dev (d,) or the lower Cholesky factor (d, d). Raises for a tree
    prior (the fused engine takes one leaf; tree priors run on
    engine='torch')."""
    p = sampler.prior
    if isinstance(p, MvNormal):
        loc = np.broadcast_to(_numpy(p.loc, "prior").astype(np.float32), (d,))
        if p.scale_tril is not None:
            return loc, np.tril(_numpy(p.scale_tril, "prior").astype(np.float32))
        if p.scale_diag is not None:
            return loc, np.broadcast_to(_numpy(p.scale_diag, "prior"), (d,))
        return loc, np.broadcast_to(_numpy(p.scale, "prior"), (d,))
    if isinstance(p, Normal):
        return (np.broadcast_to(_numpy(p.loc, "prior").astype(np.float32), (d,)),
                np.broadcast_to(_numpy(p.scale, "prior").astype(np.float32), (d,)))
    raise ValueError(
        "engine='fused' EllipticalSlice needs a single Normal/MvNormal prior leaf "
        "(pytree priors: use engine='torch').")


@traced("fused.start")
def _start_block(model, num_chains: int, initial_params, initial_state, tile_fn, consts,
                 prior_start=None):
    """The kernels' (d, C) start and its lp (1, C): a resumed state's own
    params and lp (so that a split run stays exact), else ``initial_params``
    with lp from the tile density, else ``prior_start()`` (C, d)."""
    dev = model.device
    if initial_state is not None:
        return (initial_state.params.to(dev).T.contiguous(),
                initial_state.lp.to(dev).reshape(1, -1).contiguous())
    if initial_params is None and prior_start is not None:
        params_t = prior_start().T.contiguous()
    else:
        params_t = _block_of(model, initial_params, num_chains)
    return params_t, tile_fn(params_t, *consts)


@traced("fused.layout")
def _finish_plain(samples, lps, accs):
    params, lp, accepted = _layout(samples, lps, accs)
    return (Transition(params, lp, accepted),
            Transition(params[:, -1, :], lp[:, -1], accepted[:, -1]))


def sample_fused_slice(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused slice sampling (≙ runtime/fused.py::sample_fused_slice): the
    stepping-out budget ``sampler.max_stepout`` capped at 8 and the shrink
    budget ``sampler.max_shrink`` capped at 24, as the JAX engine caps them;
    a chain that exhausts them keeps its state and reports
    accepted=False."""
    tile_fn, consts = _tile(model)
    params_t, lp0 = _start_block(model, num_chains, initial_params, initial_state, tile_fn,
                                 consts)
    samples, lps, accs = fused_slice_sample(
        tile_fn, model.cuda_density, params_t, lp0, consts, fused_seed(key),
        width=float(sampler.width), max_stepout=min(int(sampler.max_stepout), MAX_STEPOUT),
        max_shrink=min(int(sampler.max_shrink), MAX_SHRINK),
        **_emission(schedule, iteration_offset))
    return _finish_plain(samples, lps, accs)


def _prior_sampler_start(model, sampler, key, num_chains, initial_params, initial_state,
                         tile_fn, consts):
    """The start of ESS and pCN and the prior's (loc, scale) on the model's
    device. Without ``initial_params`` every chain starts at a prior draw
    ``loc + L z`` (or ``loc + σ ⊙ z``), z from the generator of step 0."""
    dev = model.device
    d = model.dimension
    if d is None:
        if initial_params is None and initial_state is None:
            raise ValueError("engine='fused' ESS and pCN need model.dimension or "
                             "initial_params")
        src = initial_state.params if initial_state is not None else initial_params
        d = int(np.asarray(_numpy(src, "initial")).shape[-1])
    as_t = lambda a: host_sync("prior", torch.as_tensor, np.array(a, np.float32), device=dev)
    with span("fused.prepare"):
        loc, scale = (as_t(a) for a in _extract_ess_prior(sampler, d))

    def prior_start():
        z = torch.randn((num_chains, d), generator=step_generator(key, 0, dev), device=dev)
        return loc + (z @ scale.T if scale.ndim == 2 else z * scale)

    params_t, lp0 = _start_block(model, num_chains, initial_params, initial_state, tile_fn,
                                 consts, prior_start)
    return params_t, lp0, loc, scale


def sample_fused_ess(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused elliptical slice sampling (≙ runtime/fused.py::sample_fused_ess):
    the model's tile density is the log-likelihood, the prior one
    Normal/MvNormal leaf, ``sampler.max_shrink`` capped at 24 trips (a chain
    that exhausts them keeps its state and reports accepted=False).
    ``initial_params=None`` starts every chain at a prior draw."""
    tile_fn, consts = _tile(model)
    params_t, lp0, loc, scale = _prior_sampler_start(model, sampler, key, num_chains,
                                                     initial_params, initial_state, tile_fn,
                                                     consts)
    samples, lps, accs = fused_ess_sample(
        tile_fn, model.cuda_density, params_t, lp0, loc, scale, consts, fused_seed(key),
        max_shrink=min(int(sampler.max_shrink), MAX_SHRINK),
        **_emission(schedule, iteration_offset))
    return _finish_plain(samples, lps, accs)


def sample_fused_pcn(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused pCN (≙ runtime/fused.py::sample_fused_pcn): the RWMH kernel with
    the state contracted toward the prior mean and the likelihood-only
    accept; one Normal/MvNormal prior leaf. ``initial_params=None`` starts
    every chain at a prior draw."""
    tile_fn, consts = _tile(model)
    params_t, lp0, loc, scale = _prior_sampler_start(model, sampler, key, num_chains,
                                                     initial_params, initial_state, tile_fn,
                                                     consts)
    samples, lps, accs = fused_pcn_sample(
        tile_fn, model.cuda_density, params_t, lp0, loc, scale, consts, fused_seed(key),
        beta=float(sampler.beta), **_emission(schedule, iteration_offset))
    return _finish_plain(samples, lps, accs)


def sample_fused_barker(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused Barker (≙ runtime/fused.py::sample_fused_barker): the gradient
    in the kernel, carried between steps as in fused MALA. The final
    ``GradientTransition`` carries the kernel's gradient at the last draws;
    a resumed ``initial_state`` gives its own lp and gradient back to the
    kernel."""
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    dev = model.device
    if initial_state is not None:
        params_t = initial_state.params.to(dev).T.contiguous()
        lp0 = initial_state.lp.to(dev).reshape(1, -1).contiguous()
        g0 = initial_state.gradient.to(dev).T.contiguous()
    else:
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        params_t = _chain_block(model, initial_params, num_chains)
        lp0, g0 = value_and_grad(params_t, *consts)
    samples, lps, accs, g_last = fused_barker_sample(
        value_and_grad, model.cuda_density, params_t, lp0, g0, consts, fused_seed(key),
        step_size=float(sampler.step_size), **_emission(schedule, iteration_offset))
    params, lp, accepted = _chains_layout(samples, lps, accs)
    final_state = GradientTransition(params[:, -1, :], lp[:, -1], g_last.T, accepted[:, -1])
    return Transition(params, lp, accepted), final_state


# ---- replica exchange and DE-MC ------------------------------------------------------


def sample_fused_tempering(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: int,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused replica exchange (≙ runtime/fused.py::sample_fused_tempering):
    the whole ladder, K tempered RWMH replicas and the even-odd swaps, in
    one launch. The inner sampler is a symmetric Gaussian random-walk
    ``MetropolisHastings`` with a scalar or diagonal scale; emissions are
    the cold replica. The final ``ReplicaExchangeState`` holds the ladder
    ``(C, K, d)``, the tempered lp β·ℓ ``(C, K)``, the cold replica's last
    move decision, the swap counts ``(C, K−1)`` (proposals: the previous
    count plus one per step) and the raw ℓ the kernel carried. A resumed
    ``initial_state`` gives the kernel that ℓ back (a state without it, from
    the torch engine or the JAX package, has its ℓ recomputed from the
    ladder with the model's tile density), so that a split run stays
    exact."""
    if initial_params is None and initial_state is None:
        raise ValueError("engine='fused' requires initial_params")
    K = len(sampler.betas)
    tile_fn, consts = _tile(model)
    dev = model.device
    if initial_state is not None:
        xs = initial_state.inner.params.to(dev, torch.float32)
        xs = xs.reshape(xs.shape[0], K, -1)  # (C, K, d); scalar params are d = 1
        C, d = xs.shape[0], xs.shape[2]
        x_t = xs.permute(1, 2, 0).reshape(K * d, C).contiguous()
        if initial_state.raw_lp is not None:
            ell0 = initial_state.raw_lp.to(dev).T.contiguous()
        else:
            ell0 = torch.cat([tile_fn(x_t[k * d:(k + 1) * d], *consts) for k in range(K)])
        sw_acc0 = initial_state.swap_accept_count.to(dev)
        sw_prop0 = initial_state.swap_proposal_count.to(dev)
    else:
        one = _chain_block(model, initial_params, num_chains)  # (d, C)
        d, C = one.shape
        x_t = one.repeat(K, 1).contiguous()
        ell0 = tile_fn(one, *consts).expand(K, C).contiguous()
        sw_acc0 = torch.zeros((C, K - 1), dtype=torch.float32, device=dev)
        sw_prop0 = torch.zeros_like(sw_acc0)
    scale = _extract_rw_scale(sampler.sampler, d)
    if scale.ndim == 2:
        raise ValueError(
            "engine='fused' tempering supports scalar/diagonal proposal scales "
            "(scale_tril ladders: use engine='torch').")
    samples, lps, accs, x_f, ell_f, sw = fused_tempering_sample(
        tile_fn, model.cuda_density, x_t, ell0, consts, fused_seed(key),
        betas=sampler.betas, scale=np.array(scale, np.float32),
        replica_scales=sampler.replica_scales, **_emission(schedule, iteration_offset))
    params, lp, accepted = _chains_layout(samples, lps, accs)
    betas = torch.tensor(sampler.betas, dtype=torch.float32, device=dev)
    inner_acc = torch.zeros((C, K), dtype=torch.bool, device=dev)
    inner_acc[:, 0] = accepted[:, -1]
    final_state = ReplicaExchangeState(
        inner=Transition(x_f.reshape(K, d, C).permute(2, 0, 1), (ell_f * betas[:, None]).T,
                         inner_acc),
        swap_accept_count=sw_acc0 + sw.T,
        swap_proposal_count=sw_prop0 + float(schedule.burn
                                              + schedule.n_samples * schedule.thinning),
        raw_lp=ell_f.T)
    return Transition(params, lp, accepted), final_state


def sample_fused_demc(
    model,
    sampler,
    schedule: Schedule,
    *,
    key: int,
    num_chains: Optional[int] = None,
    initial_params,
    initial_state=None,
    iteration_offset: int = 0,
):
    """Fused DE-MC (≙ runtime/fused.py::sample_fused_demc) on one
    population of all M members (any even M >= 6; the JAX engine's
    multiple-of-256 rule and tiles of independent populations are TPU lane
    facts). Without ``initial_params`` every member starts at a payload
    draw, as ``sample(engine="torch")`` draws it; a resumed ``initial_state``
    (a final ``Transition``) carries its own lp, so that a split run stays
    exact. Returns member-layout transitions: params (N, M, d), lp and
    accepted (N, M). ``num_chains`` is unused: the members are the batch
    axis."""
    M = sampler.n_members
    check_members(M)
    tile_fn, consts = _tile(model)
    dev = model.device
    if initial_state is not None:
        x = initial_state.params.to(dev, torch.float32)
        lp0 = initial_state.lp.to(dev).reshape(1, -1).contiguous()
    else:
        if initial_params is None:
            init_tr, _ = sampler.init(step_generator(key, 0, dev), model)
            initial_params = init_tr.params
        x = torch.as_tensor(initial_params, dtype=torch.float32).to(dev)
        lp0 = None
    if x.shape[0] != M:
        raise ValueError(f"initial_params carries {x.shape[0]} members but the sampler was "
                         f"built with n_members={M}")
    params_t = x.reshape(M, -1).T.contiguous()
    if lp0 is None:
        lp0 = tile_fn(params_t, *consts)
    d = params_t.shape[0]
    samples, lps, accs = fused_demc_sample(
        tile_fn, model.cuda_density, params_t, lp0, consts, fused_seed(key),
        params=DemcParams(sampler._gamma(d), sampler.noise_scale, sampler.jump_probability,
                          sampler.snooker_probability, sampler.snooker_gamma),
        **_emission(schedule, iteration_offset))
    params = samples.permute(0, 2, 1)  # (N, M, d)
    lp, accepted = lps[:, 0, :], accs[:, 0, :] > 0.5
    return (Transition(params, lp, accepted),
            Transition(params[-1], lp[-1], accepted[-1]))


# ---- the table ---------------------------------------------------------------------


class Runner(NamedTuple):
    """A sampler class's fused runner, and whether the sampler's walkers or
    members are the batch axis (it then runs with no ``num_chains``)."""

    run: Callable
    population: bool = False


# The runner of each sampler class with fused kernels; :func:`runner_of` takes the
# entry of the most specific class in a sampler's MRO (an MTM is an MH).
RUNNERS = {
    MetropolisHastings: Runner(sample_fused),
    MultipleTryMetropolis: Runner(sample_fused_mtm),
    DelayedRejection: Runner(sample_fused_dr),
    MALA: Runner(sample_fused_mala),
    RobustAdaptiveMetropolis: Runner(sample_fused_ram),
    Ensemble: Runner(sample_fused_emcee, population=True),
    StepSizeAdaptation: Runner(sample_fused_adapt_rwmh),
    HamiltonianMC: Runner(sample_fused_hmc),
    AdaptiveHMC: Runner(sample_fused_adaptive_hmc),
    ChEESHMC: Runner(sample_fused_chees),
    MEADS: Runner(sample_fused_meads),
    SliceSampler: Runner(sample_fused_slice),
    EllipticalSlice: Runner(sample_fused_ess),
    Barker: Runner(sample_fused_barker),
    PreconditionedCrankNicolson: Runner(sample_fused_pcn),
    AdaptiveMetropolis: Runner(sample_fused_am),
    DRAM: Runner(sample_fused_am),
    ReplicaExchange: Runner(sample_fused_tempering),
    DifferentialEvolution: Runner(sample_fused_demc, population=True),
}


def runner_of(sampler) -> Optional[Runner]:
    """The entry of the most specific class of ``sampler`` in
    :data:`RUNNERS`, or None."""
    return next((RUNNERS[cls] for cls in type(sampler).__mro__ if cls in RUNNERS), None)


def run(model, sampler, schedule: Schedule, *, key: int, num_chains: Optional[int],
        initial_params, initial_state, iteration_offset: int):
    """``sample(engine="fused")``'s draws: (transitions, final_state) from
    the runner of ``sampler``'s class; raises for a sampler no kernel runs."""
    runner = runner_of(sampler)
    if runner is None:
        raise ValueError(_not_ported(f"got {type(sampler).__name__}"))
    return runner.run(model, sampler, schedule, key=key, num_chains=num_chains,
                      initial_params=initial_params, initial_state=initial_state,
                      iteration_offset=iteration_offset)
