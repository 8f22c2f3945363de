"""Fused-engine dispatch: ``sample(engine="fused")`` on the CUDA kernels.

≙ advancedmh_tpu/runtime/fused.py, for the samplers whose kernels are
ported (on CPU tensors each kernel's plain PyTorch version runs instead):

- ``MetropolisHastings`` with one zero-mean Gaussian random-walk leaf
  (RWMH, ``ops/rwmh.py``);
- ``MALA.langevin(step_size_sq)`` (``ops/mala.py``);
- ``RobustAdaptiveMetropolis``, per-chain or pooled (``ops/ram.py``);
- ``Ensemble`` with a ``StretchProposal`` (``ops/emcee.py``).

The model must name a CUDA density (``model.cuda_density``, with its plain
``tile_density``, ``tile_value_and_grad`` for MALA, and ``tile_consts``; see
models/targets.py).

Schedule contract: sample k is the state after ``burn + (k+1)*thinning``
steps with ``burn = max(discard_initial - thinning, 0)``, identical to the
standard schedule when ``discard_initial >= thinning`` (the init state is
never emitted); for RAM, ``burn`` is the ``num_warmup`` adaptive steps. Step
t of the run is absolute iteration ``iteration_offset + t``, and its noise
depends only on (seed, iteration, chain or walker), so a run split at any
point and resumed with ``initial_state`` and ``iteration_offset`` gives the
same draws as an unsplit one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributions import MvNormal, Normal
from ..ops.emcee import check_walkers, fused_emcee_sample
from ..ops.mala import fused_mala_sample
from ..ops.ram import RamParams, fused_ram_sample
from ..ops.rwmh import fused_rwmh_sample
from ..proposals import RandomWalkProposal, is_proposal
from ..samplers.base import GradientTransition, Transition
from ..samplers.emcee import StretchProposal
from ..samplers.mh import MetropolisHastings
from ..samplers.ram import RobustAdaptiveMetropolisState
from ..utils.keys import splitmix64, step_generator

_NOT_PORTED = (
    "engine='fused' in advancedmh_tpu_torch runs MetropolisHastings with one "
    "zero-mean Gaussian RandomWalkProposal (RWMH), MALA.langevin, "
    "RobustAdaptiveMetropolis and Ensemble with a StretchProposal; {what}. "
    "The fused kernels of the other samplers are listed in ROADMAP.md, "
    "'Queue 2 — TPU kernels to port'; use engine='torch' meanwhile."
)


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _extract_rw_scale(sampler, d: int) -> np.ndarray:
    """The proposal scale, per-dimension ``(d,)`` or lower Cholesky
    ``(d, d)``; raises unless the sampler is a symmetric Gaussian RW."""
    if not isinstance(sampler, MetropolisHastings):
        raise ValueError(_NOT_PORTED.format(what=f"got {type(sampler).__name__}"))
    return _rw_leaf_scale(sampler.proposal, d)


def _rw_leaf_scale(p, d: int) -> np.ndarray:
    """Scale of a single zero-mean Gaussian RandomWalkProposal leaf."""
    if not is_proposal(p) or not isinstance(p, RandomWalkProposal):
        raise ValueError(_NOT_PORTED.format(what="the proposal is not a single RandomWalkProposal leaf"))
    payload = p.payload
    if isinstance(payload, (MvNormal, Normal)):
        if not np.allclose(_numpy(payload.loc), 0.0):
            raise ValueError(_NOT_PORTED.format(what="the increment is not zero-mean"))
        if isinstance(payload, MvNormal) and payload.scale_tril is not None:
            return np.tril(_numpy(payload.scale_tril).astype(np.float32))
        if isinstance(payload, MvNormal) and payload.scale_diag is not None:
            return np.broadcast_to(_numpy(payload.scale_diag), (d,))
        return np.broadcast_to(_numpy(payload.scale), (d,))
    raise ValueError(
        _NOT_PORTED.format(what=f"payload {type(payload).__name__} is not Normal or MvNormal")
    )


def fused_seed(master: int) -> int:
    """The kernels' 64-bit Philox seed for a master key."""
    return splitmix64(master)


def _tile(model, attr: str = "tile_density"):
    """The model's plain tile function ``attr`` and its constants."""
    fn = getattr(model, attr, None)
    if fn is None:
        raise ValueError(
            f"engine='fused' needs a model with a {attr} and a CUDA density "
            "tag (models/targets.py); other densities wait for the "
            "tile-density contract in ROADMAP.md"
        )
    return fn, tuple(model.tile_consts)


def _chain_block(model, initial_params, num_chains: int):
    """Initial params as the kernels' (d, C) block on the model's device:
    one point broadcast to every chain, or one row per chain."""
    if initial_params is None:
        raise ValueError("engine='fused' requires initial_params")
    init = torch.as_tensor(initial_params, dtype=torch.float32).to(model.device)
    d = model.dimension if model.dimension is not None else int(init.shape[-1])
    if init.ndim == 1:
        return init[:, None].expand(d, num_chains).contiguous()
    return init.T.contiguous()


def _chains_layout(samples, lps, accs):
    """(N, d, C), (N, 1, C) → (C, N, d), (C, N), (C, N) bool. Views:
    bundling into Chains permutes back to the kernel's contiguous layout."""
    return samples.permute(2, 0, 1), lps[:, 0, :].T, accs[:, 0, :].T > 0.5


def sample_fused(
    model,
    sampler,
    n_samples: int,
    *,
    key: int,
    num_chains: int,
    initial_params,
    discard_initial: int,
    thinning: int,
    iteration_offset: int = 0,
):
    """Run the fused RWMH kernel; returns (transitions, final_state) in
    the standard (chains, samples, ...) layout."""
    tile_fn, consts = _tile(model)
    params_t = _chain_block(model, initial_params, num_chains)
    d = params_t.shape[0]
    scale = torch.as_tensor(np.ascontiguousarray(_extract_rw_scale(sampler, d)),
                            dtype=torch.float32, device=model.device)
    burn = max(discard_initial - thinning, 0)
    lp0 = tile_fn(params_t, *consts)
    samples, lps, accs = fused_rwmh_sample(
        tile_fn, model.cuda_density, params_t, lp0, scale, consts,
        fused_seed(key), burn=burn, thin=thinning, n_samples=n_samples,
        iteration_offset=iteration_offset,
    )
    params, lp, accepted = _chains_layout(samples, lps, accs)
    final_state = Transition(params[:, -1, :], lp[:, -1], accepted[:, -1])
    return Transition(params, lp, accepted), final_state


def sample_fused_mala(
    model,
    sampler,
    n_samples: int,
    *,
    key: int,
    num_chains: int,
    initial_params,
    discard_initial: int,
    thinning: int,
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
    if initial_params is None:
        raise ValueError("please specify initial parameters")
    value_and_grad, consts = _tile(model, "tile_value_and_grad")
    params_t = _chain_block(model, initial_params, num_chains)
    lp0, g0 = value_and_grad(params_t, *consts)
    samples, lps, accs, g_last = fused_mala_sample(
        value_and_grad, model.cuda_density, params_t, lp0, g0, consts,
        fused_seed(key), step_size_sq=s2, burn=max(discard_initial - thinning, 0),
        thin=thinning, n_samples=n_samples, iteration_offset=iteration_offset,
    )
    params, lp, accepted = _chains_layout(samples, lps, accs)
    final_state = GradientTransition(params[:, -1, :], lp[:, -1], g_last.T,
                                     accepted[:, -1])
    return Transition(params, lp, accepted), final_state


def _pooled_warmup(model, sampler, key: int, init: torch.Tensor,
                   num_warmup: int, iteration_offset: int):
    """Stage 1 of pooled RAM: the rank-C pooled warmup on the torch engine
    (its reduction spans every chain), steps 1..num_warmup drawn as
    ``sample(engine="torch")`` draws them."""
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
    n_samples: int,
    *,
    key: int,
    num_chains: int,
    initial_params,
    num_warmup: int,
    discard_initial: int,
    thinning: int,
    initial_S=None,
    iteration_offset: int = 0,
):
    """Run the fused RAM kernel (≙ JAX ``sample_fused_ram``): the adaptive
    warmup and the frozen-S draws in one launch. Fresh runs need the
    standard schedule ``discard_initial == num_warmup``; a resumed run
    (``initial_S`` from a final state) continues frozen and needs
    ``num_warmup == 0``, ``discard_initial == thinning``.

    ``pooled=True`` runs in two stages: the pooled warmup on the torch
    engine adapts one shared S, then the kernel runs frozen (warmup 0) from
    it. Post-warmup RAM never adapts, so the staging changes no algorithm."""
    if initial_S is None:
        if discard_initial != num_warmup:
            raise ValueError(
                "fused RAM supports the standard schedule discard_initial == "
                "num_warmup; use engine='torch' to keep warmup draws."
            )
    elif num_warmup != 0 or discard_initial != thinning:
        raise ValueError(
            "fused RAM resume expects the resume schedule "
            "(num_warmup=0, discard_initial=thinning)."
        )
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
    n_samples: int,
    *,
    key: int,
    initial_params,
    discard_initial: int,
    thinning: int,
    iteration_offset: int = 0,
):
    """Run the fused emcee kernel (≙ JAX ``sample_fused_emcee``) on one
    ensemble of all W walkers (any even W). Without ``initial_params`` the
    walkers are drawn from the proposal's payload, as
    ``sample(engine="torch")`` draws them. Returns walker-layout
    transitions: params (N, W, d), lp and accepted (N, W)."""
    if not isinstance(sampler.proposal, StretchProposal):
        raise NotImplementedError(
            "engine='fused' emcee supports StretchProposal only; the walk "
            "move needs O(n_walkers) fresh normals per walker-step (use "
            "engine='torch')"
        )
    W = sampler.n_walkers
    check_walkers(W, W)
    tile_fn, consts = _tile(model)
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
        burn=max(discard_initial - thinning, 0), thin=thinning,
        n_samples=n_samples, iteration_offset=iteration_offset,
    )
    params = samples.permute(0, 2, 1)  # (N, W, d)
    lp, accepted = lps[:, 0, :], accs[:, 0, :] > 0.5
    return (Transition(params, lp, accepted),
            Transition(params[-1], lp[-1], accepted[-1]))
