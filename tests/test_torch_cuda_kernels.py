"""The CUDA RWMH kernels against their plain PyTorch versions, on the card.

These tests need a CUDA GPU (marker ``cuda``) and skip without one. Run them
on a GPU machine with ``python -m pytest tests/test_torch_cuda_kernels.py``.
Tolerances as in chip_smoke.py: at least 99.9% of accept decisions equal,
and on chains whose decisions agree, states and lp within 1e-5 relative
(floor 1e-5): CUDA's logf / sincosf may differ from PyTorch's in the last
ulp, and the observation sum runs in another order.
"""
import numpy as np
import pytest
import torch

from advancedmh_tpu_torch.models import gaussian_mean_scale_model
from advancedmh_tpu_torch.ops import (
    fused_rwmh,
    fused_rwmh_sample,
    rwmh_reference,
    rwmh_sample_reference,
)

pytestmark = pytest.mark.cuda

SCALES = {"diag": [0.35, 0.35], "tril": [[0.35, 0.0], [0.1, 0.3]]}


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")
    return gaussian_mean_scale_model(device="cuda")


def _start(model, C, seed):
    rng = np.random.default_rng(seed)
    p = torch.tensor(np.stack([rng.normal(size=C), rng.uniform(-0.5, 2.0, size=C)]),
                     dtype=torch.float32, device="cuda")
    return p, model.tile_density(p, *model.tile_consts)


def _args(model, p, lp, form):
    scale = torch.tensor(SCALES[form], device="cuda")
    return (model.tile_density, model.cuda_density, p, lp, scale, model.tile_consts, 4242)


def _close(a, b):
    return torch.isclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["diag", "tril"])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (300, 0, 1, 64, 0), (257, 5, 3, 11, 9), (512, 3, 1, 33, (1 << 32) - 10),
])
def test_sample_kernel_matches_plain(model, form, C, burn, thin, n, offset):
    p, lp = _start(model, C, seed=C)
    args = _args(model, p, lp, form)
    kw = dict(burn=burn, thin=thin, n_samples=n, iteration_offset=offset)
    before = fused_rwmh_sample.launches
    s, l, a = fused_rwmh_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_rwmh_sample.launches == before + 1
    s_r, l_r, a_r = rwmh_sample_reference(*args, **kw)
    dec = (a == a_r)[:, 0, :]
    assert float(dec.float().mean()) >= 0.999
    ok = dec.all(0) & _close(s, s_r).all(dim=(0, 1)) & _close(l, l_r).all(dim=(0, 1))
    assert float(ok.float().mean()) >= 0.999


@pytest.mark.parametrize("form", ["diag", "tril"])
@pytest.mark.parametrize("n_steps", [1, 63])
def test_step_kernel_matches_plain(model, form, n_steps):
    p, lp = _start(model, 1000, seed=n_steps)
    args = _args(model, p, lp, form)
    x, l, acc = fused_rwmh(*args, n_steps=n_steps, iteration_offset=5)
    x_r, l_r, acc_r = rwmh_reference(*args, n_steps=n_steps, iteration_offset=5)
    ok = (acc == acc_r)[0] & _close(x, x_r).all(0) & _close(l, l_r)[0]
    assert float(ok.float().mean()) >= 0.999


def test_wrapper_raises_for_what_has_no_kernel(model):
    p, lp = _start(model, 64, seed=1)
    scale = torch.tensor([0.3, 0.3], device="cuda")
    with pytest.raises(ValueError, match="CUDA density"):
        fused_rwmh(model.tile_density, None, p, lp, scale, model.tile_consts, 1, n_steps=2)
    with pytest.raises(ValueError, match="no CUDA density named"):
        fused_rwmh(model.tile_density, "banana", p, lp, scale, model.tile_consts, 1, n_steps=2)
    p3 = torch.zeros(3, 64, device="cuda")
    with pytest.raises(ValueError, match="instantiated"):
        fused_rwmh(model.tile_density, model.cuda_density, p3, lp, torch.ones(3, device="cuda"),
                   model.tile_consts, 1, n_steps=2)
