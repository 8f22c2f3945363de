"""Fused-engine dispatch: ``sample(engine="fused")`` on the CUDA RWMH kernel.

≙ advancedmh_tpu/runtime/fused.py, the RWMH part. Applicable when the
sampler is a ``MetropolisHastings`` with one zero-mean Gaussian random-walk
leaf and the model names a CUDA density (``model.cuda_density``, with its
plain ``tile_density`` and ``tile_consts``; see models/targets.py).

Schedule contract: sample k is the state after ``burn + (k+1)*thinning``
steps with ``burn = max(discard_initial - thinning, 0)``, identical to the
standard schedule when ``discard_initial >= thinning`` (the init state is
never emitted). Step t of the run is absolute iteration
``iteration_offset + t``, and its noise depends only on (seed, iteration,
chain), so a run split at any point and resumed with ``initial_state`` and
``iteration_offset`` gives the same draws as an unsplit one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..distributions import MvNormal, Normal
from ..ops.rwmh import fused_rwmh_sample
from ..proposals import RandomWalkProposal, is_proposal
from ..samplers.base import Transition
from ..samplers.mh import MetropolisHastings
from ..utils.keys import splitmix64

_NOT_PORTED = (
    "engine='fused' in advancedmh_tpu_torch runs only MetropolisHastings with "
    "one zero-mean Gaussian RandomWalkProposal (RWMH); {what}. The fused "
    "kernels of the other samplers are listed in ROADMAP.md, 'Queue 2 — TPU "
    "kernels to port'; use engine='torch' meanwhile."
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
    """Run the fused sampling kernel; returns (transitions, final_state) in
    the standard (chains, samples, ...) layout."""
    tile_fn = getattr(model, "tile_density", None)
    if tile_fn is None:
        raise ValueError(
            "engine='fused' needs a model with a tile density and a CUDA "
            "density tag (models/targets.py); other densities wait for the "
            "tile-density contract in ROADMAP.md"
        )
    if initial_params is None:
        raise ValueError("engine='fused' requires initial_params")
    device = model.device
    init = torch.as_tensor(initial_params, dtype=torch.float32).to(device)
    d = model.dimension if model.dimension is not None else int(init.shape[-1])
    scale = torch.as_tensor(np.ascontiguousarray(_extract_rw_scale(sampler, d)),
                            dtype=torch.float32, device=device)
    burn = max(discard_initial - thinning, 0)
    if init.ndim == 1:
        params_t = init[:, None].expand(d, num_chains).contiguous()
    else:  # batched (C, d)
        params_t = init.T.contiguous()
    consts = tuple(model.tile_consts)
    lp0 = tile_fn(params_t, *consts)

    samples, lps, accs = fused_rwmh_sample(
        tile_fn, model.cuda_density, params_t, lp0, scale, consts,
        fused_seed(key), burn=burn, thin=thinning, n_samples=n_samples,
        iteration_offset=iteration_offset,
    )
    # (N, d, C) → (C, N, d); (N, 1, C) → (C, N). Views: bundling into
    # Chains permutes back to the kernel's contiguous layout.
    params = samples.permute(2, 0, 1)
    lp = lps[:, 0, :].T
    accepted = accs[:, 0, :].T > 0.5
    transitions = Transition(params, lp, accepted)
    final_state = Transition(params[:, -1, :], lp[:, -1], accepted[:, -1])
    return transitions, final_state
