"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA GPU (marker ``cuda``) and skip without one. Run them
on a GPU machine with ``python -m pytest --noconftest
tests/test_torch_cuda_kernels.py``. Tolerances as in chip_smoke.py: at least
99.9% of accept decisions equal, and on chains whose decisions agree, states
and lp within 1e-5 relative (floor 1e-5): CUDA's logf / sincosf may differ
from PyTorch's in the last ulp, and the observation sum runs in another
order. So a decision can land within lp's last bits and part a chain from
the plain version (2.6e-7 times per chain-step on the flagship on an H100):
the cases run about 4000 chains, where one such chain stays inside 99.9%.
"""
import numpy as np
import pytest
import torch

from advancedmh_tpu_torch.models import (
    correlated_gaussian_model,
    emcee_demo_model,
    gaussian_mean_scale_model,
)
from advancedmh_tpu_torch.ops import (
    RamParams,
    _build,
    emcee_sample_reference,
    fused_emcee_sample,
    fused_mala_sample,
    fused_ram_sample,
    fused_rwmh,
    fused_rwmh_sample,
    mala_sample_reference,
    ram_sample_reference,
    rwmh_reference,
    rwmh_sample_reference,
)

pytestmark = pytest.mark.cuda

SCALES = {"diag": [0.35, 0.35], "tril": [[0.35, 0.0], [0.1, 0.3]]}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")


@pytest.fixture
def model():
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
    (4096, 0, 1, 64, 0), (4001, 5, 3, 11, 9), (4099, 3, 1, 33, (1 << 32) - 10),
    (4003, 0, 10, 9, 77), (4001, 7, 10, 5, 0),
])
def test_sample_kernel_matches_plain(model, form, C, burn, thin, n, offset):
    """The flagship in the group form (C not a multiple of a block's chains,
    step counts not a multiple of the lanes), against the plain version on
    the ordered tile density; one launch, counted as a group launch."""
    p, lp = _start(model, C, seed=C)
    args = _args(model, p, lp, form)
    kw = dict(burn=burn, thin=thin, n_samples=n, iteration_offset=offset)
    before = (fused_rwmh_sample.launches, fused_rwmh_sample.group_launches)
    s, l, a = fused_rwmh_sample(*args, **kw)
    torch.cuda.synchronize()
    assert (fused_rwmh_sample.launches, fused_rwmh_sample.group_launches) == (
        before[0] + 1, before[1] + 1)
    s_r, l_r, a_r = rwmh_sample_reference(*args, **kw)
    dec = (a == a_r)[:, 0, :]
    assert float(dec.float().mean()) >= 0.999
    ok = dec.all(0) & _close(s, s_r).all(dim=(0, 1)) & _close(l, l_r).all(dim=(0, 1))
    assert float(ok.float().mean()) >= 0.999


@pytest.mark.parametrize("form", ["diag", "tril"])
@pytest.mark.parametrize("n_steps", [1, 8, 63])
def test_step_kernel_matches_plain(model, form, n_steps):
    p, lp = _start(model, 4001, seed=n_steps)
    args = _args(model, p, lp, form)
    before = (fused_rwmh.launches, fused_rwmh.group_launches)
    x, l, acc = fused_rwmh(*args, n_steps=n_steps, iteration_offset=5)
    assert (fused_rwmh.launches, fused_rwmh.group_launches) == (before[0] + 1, before[1] + 1)
    x_r, l_r, acc_r = rwmh_reference(*args, n_steps=n_steps, iteration_offset=5)
    ok = (acc == acc_r)[0] & _close(x, x_r).all(0) & _close(l, l_r)[0]
    assert float(ok.float().mean()) >= 0.999


@pytest.mark.parametrize("target,lanes", [
    ("flagship", 2), ("flagship300", 1), ("corr2", 1), ("corr4", 1), ("corr8", 1),
    ("emcee", 1), ("logreg", 1),
])
def test_rwmh_form_and_group_launches(model, target, lanes):
    """The form csrc/rwmh.cu picks: the flagship (30 observations) runs 2
    lanes a chain, 64 chains a block, no shared memory, and each kernel
    counts a group launch; the other five densities and the flagship with
    300 observations (more than the lanes' registers hold) run one thread a
    chain with the constants in shared memory and count none. Both forms
    agree with their plain versions."""
    from advancedmh_tpu_torch.models import logistic_regression_model
    from advancedmh_tpu_torch.ops._build import flat_consts
    from advancedmh_tpu_torch.ops.rwmh import rwmh_launch_info

    make = {
        "flagship": lambda: model,
        "flagship300": lambda: gaussian_mean_scale_model(n_obs=300, device="cuda"),
        "corr2": lambda: correlated_gaussian_model(CORR, device="cuda"),
        "corr4": lambda: correlated_gaussian_model(CORR4, device="cuda"),
        "corr8": lambda: correlated_gaussian_model(
            (0.5 * np.ones((8, 8)) + 0.5 * np.eye(8)).tolist(), device="cuda"),
        "emcee": lambda: emcee_demo_model(device="cuda"),
        "logreg": lambda: logistic_regression_model(256, 32, seed=0, device="cuda"),
    }
    m = make[target]()
    d, C, n_consts = m.dimension, 1001, flat_consts(m.tile_consts, "cuda")[1]
    for tril in (False, True):
        info = rwmh_launch_info(m.cuda_density, d, tril, n_consts, C)
        assert info["lanes_per_chain"] == lanes and info["threads"] == 128
        assert 0 < info["registers"] <= 255
        assert info["chains_per_block"] == 128 // lanes
        assert info["smem_bytes"] == (0 if lanes > 1 else 4 * n_consts)
    p = (_start(m, C, seed=3)[0] if target.startswith("flagship") else
         0.5 * _gauss_start(d, C, seed=3).abs() + (0.5 if target == "emcee" else 0.0))
    lp = m.tile_density(p, *m.tile_consts)
    args = (m.tile_density, m.cuda_density, p, lp, 0.3, m.tile_consts, 19)
    before = (fused_rwmh_sample.group_launches, fused_rwmh.group_launches)
    got = fused_rwmh_sample(*args, burn=2, thin=3, n_samples=9)
    fused_rwmh(*args, n_steps=5)
    counted = int(lanes > 1)
    assert (fused_rwmh_sample.group_launches, fused_rwmh.group_launches) == (
        before[0] + counted, before[1] + counted)
    dec, chains = _agree(got, rwmh_sample_reference(*args, burn=2, thin=3, n_samples=9))
    assert dec >= 0.999 and chains >= 0.999


def _agree(got, ref):
    """Fraction of equal decisions and of chains equal in every output."""
    (s, l, a), (s_r, l_r, a_r) = got[:3], ref[:3]
    dec = (a == a_r)[:, 0, :]
    ok = dec.all(0) & _close(s, s_r).all(dim=(0, 1)) & _close(l, l_r).all(dim=(0, 1))
    return float(dec.float().mean()), float(ok.float().mean())


CORR = [[1.5, 0.35], [0.35, 1.0]]
CORR4 = (0.5 * np.ones((4, 4)) + 0.5 * np.eye(4)).tolist()


def _gauss_start(d, C, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(d, C)), dtype=torch.float32, device="cuda")


@pytest.mark.parametrize("target", ["flagship", "corr2", "corr4"])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (4096, 0, 1, 64, 0), (4001, 5, 3, 11, 9), (4099, 3, 1, 33, (1 << 32) - 10),
])
def test_mala_kernel_matches_plain(model, target, C, burn, thin, n, offset):
    if target == "flagship":
        m, s2 = model, 0.02
        p, _ = _start(m, C, seed=C)
    else:
        m, s2 = correlated_gaussian_model(CORR if target == "corr2" else CORR4,
                                          device="cuda"), 0.5
        p = _gauss_start(m.dimension, C, seed=C)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    args = (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 77)
    kw = dict(step_size_sq=s2, burn=burn, thin=thin, n_samples=n, iteration_offset=offset)
    before = fused_mala_sample.launches
    got = fused_mala_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_mala_sample.launches == before + 1
    ref = mala_sample_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    # The final gradient on chains whose states agree. The flagship's sigma
    # component is n*m - sum(z*r) over (m*m): the two terms nearly cancel, so
    # the sum's order moves it by up to ~1e-4 relative.
    same = (got[2] == ref[2]).all(0)[0] & _close(got[0], ref[0]).all(dim=(0, 1))
    g_ok = torch.isclose(got[3], ref[3], rtol=1e-4, atol=1e-4).all(0)
    assert bool(g_ok[same].all())


@pytest.mark.parametrize("target", ["flagship", "corr2", "corr4"])
@pytest.mark.parametrize("bounds", [(0.0, float("inf")), (0.1, 2.0)])
@pytest.mark.parametrize("C,warmup,thin,n,offset", [
    (4096, 40, 1, 24, 0), (4001, 10, 3, 11, (1 << 32) - 20),
])
def test_ram_kernel_matches_plain(model, target, bounds, C, warmup, thin, n, offset):
    if target == "flagship":
        m = model
        p, lp = _start(m, C, seed=C)
    else:
        m = correlated_gaussian_model(CORR if target == "corr2" else CORR4, device="cuda")
        p = _gauss_start(m.dimension, C, seed=C)
        lp = m.tile_density(p, *m.tile_consts)
    d = m.dimension
    S = (0.5 * torch.eye(d, device="cuda")).reshape(d * d, 1).expand(d * d, C).contiguous()
    args = (m.tile_density, m.cuda_density, p, lp, S, m.tile_consts, 91)
    kw = dict(warmup=warmup, thin=thin, n_samples=n, iteration_offset=offset,
              params=RamParams(eig_lo=bounds[0], eig_hi=bounds[1]))
    got = fused_ram_sample(*args, **kw)
    ref = ram_sample_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    assert float(_close(got[3], ref[3]).all(0).float().mean()) >= 0.999


@pytest.mark.parametrize("W,T,burn,thin,n,offset", [
    (512, 512, 0, 1, 64, 0), (1000, 250, 7, 2, 20, 5), (768, 128, 3, 1, 30, (1 << 32) - 12),
])
def test_emcee_kernel_matches_plain(W, T, burn, thin, n, offset):
    m = emcee_demo_model(device="cuda")
    rng = np.random.default_rng(W)
    x = torch.tensor(np.stack([rng.uniform(-0.2, 4.0, W), rng.normal(1.0, 1.0, W)]),
                     dtype=torch.float32, device="cuda")
    lp = m.tile_density(x)
    args = (m.tile_density, m.cuda_density, x, lp, m.tile_consts, 5)
    kw = dict(stretch_length=2.0, tile_walkers=T, burn=burn, thin=thin,
              n_samples=n, iteration_offset=offset)
    before = fused_emcee_sample.launches
    got = fused_emcee_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_emcee_sample.launches == before + 1
    dec, chains = _agree(got, emcee_sample_reference(*args, **kw))
    assert dec >= 0.999 and chains >= 0.999


def test_wrapper_raises_for_what_has_no_kernel(model):
    """An unknown tag, a missing tag, or a (tag, d) the library lacks raises
    the one ValueError of _build.check, for each of the five kernels."""
    p, lp = _start(model, 64, seed=1)
    consts = model.tile_consts
    g = torch.zeros_like(p)
    S = torch.eye(2, device="cuda").reshape(4, 1).expand(4, 64).contiguous()
    p3, S3 = torch.zeros(3, 64, device="cuda"), torch.zeros(9, 64, device="cuda")
    g3 = torch.zeros_like(p3)
    calls = {
        "rwmh_sample": lambda tag, x: fused_rwmh_sample(
            model.tile_density, tag, x, lp, torch.ones(x.shape[0], device="cuda"),
            consts, 1, burn=0, thin=1, n_samples=2),
        "rwmh": lambda tag, x: fused_rwmh(
            model.tile_density, tag, x, lp, torch.ones(x.shape[0], device="cuda"),
            consts, 1, n_steps=2),
        "mala": lambda tag, x: fused_mala_sample(
            model.tile_value_and_grad, tag, x, lp, g if x.shape[0] == 2 else g3,
            consts, 1, step_size_sq=0.1, burn=0, thin=1, n_samples=2),
        "ram": lambda tag, x: fused_ram_sample(
            model.tile_density, tag, x, lp, S if x.shape[0] == 2 else S3,
            consts, 1, warmup=1, thin=1, n_samples=2),
        "emcee": lambda tag, x: fused_emcee_sample(
            model.tile_density, tag, x, lp, consts, 1, stretch_length=2.0,
            tile_walkers=64, burn=0, thin=1, n_samples=2),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA density tag"):
            call(None, p)
        with pytest.raises(ValueError, match="'banana'"):
            call("banana", p)
        with pytest.raises(ValueError, match="instantiates only"):
            call(model.cuda_density, p3)
        has = ("emcee_demo", 2) if name == "emcee" else ("gaussian_mean_scale", 2)
        assert has in _build.kernel_pairs(
            _build.library(), "rwmh" if name.startswith("rwmh") else name)


# ---- slice 3: dual-averaging RWMH, HMC, AdaptiveHMC, and the d = 32 target ----


def _logreg():
    from advancedmh_tpu_torch.models import logistic_regression_model

    return logistic_regression_model(256, 32, seed=0, device="cuda")


def _slice3_start(m, C, seed):
    rng = np.random.default_rng(seed)
    if m.cuda_density == "gaussian_mean_scale":
        return _start(m, C, seed)[0]
    if m.cuda_density == "logistic_regression":
        return torch.tensor(0.3 * rng.normal(size=(32, C)), dtype=torch.float32, device="cuda")
    return _gauss_start(m.dimension, C, seed)


def _slice3_model(model, target):
    if target == "flagship":
        return model
    if target == "logreg":
        return _logreg()
    return correlated_gaussian_model(CORR, device="cuda")


@pytest.mark.parametrize("target", ["flagship", "corr2", "logreg"])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (4096, 0, 1, 64, 0), (4001, 5, 3, 11, (1 << 32) - 20),
])
def test_hmc_kernel_matches_plain(model, target, C, burn, thin, n, offset):
    from advancedmh_tpu_torch.ops import fused_hmc_sample, hmc_sample_reference, minv_column

    m = _slice3_model(model, target)
    if target == "logreg" and burn:  # the main path's width, the bench's step
        C, n = 8192, 16
    d = m.dimension
    p = _slice3_start(m, C, seed=C + 1)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    eps = {"flagship": 0.03, "corr2": 0.4, "logreg": 0.05}[target]
    minv = minv_column(torch.linspace(0.5, 1.5, d), d, "cuda")
    args = (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 31)
    kw = dict(step_size=eps, n_leapfrog=8, inverse_mass=minv, burn=burn, thin=thin,
              n_samples=n, iteration_offset=offset)
    before = fused_hmc_sample.launches
    got = fused_hmc_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_hmc_sample.launches == before + 1
    ref = hmc_sample_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999


@pytest.mark.parametrize("target", ["flagship", "corr2", "logreg"])
@pytest.mark.parametrize("resume", [False, True])
def test_adaptive_hmc_kernel_matches_plain(model, target, resume):
    from advancedmh_tpu_torch.ops import (DualAveraging, adaptive_hmc_reference,
                                          fused_adaptive_hmc_sample)

    m = _slice3_model(model, target)
    C = 8192 if target == "logreg" else 4000
    d = m.dimension
    p = _slice3_start(m, C, seed=7)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    args = (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 41)
    kw = dict(n_leapfrog=8, thin=1 if target == "logreg" else 3, n_samples=16,
              da=DualAveraging(0.05, 0.65), iteration_offset=9)
    if resume:
        rng = np.random.default_rng(3)
        scale = {"flagship": 0.01, "corr2": 0.3, "logreg": 0.02}[target]
        kw.update(warmup=0,
                  log_eps_bar=torch.tensor(np.log(rng.uniform(0.5, 1.5, (1, C)) * scale),
                                           dtype=torch.float32, device="cuda"),
                  inverse_mass=torch.tensor(rng.uniform(0.5, 2.0, (d, C)),
                                            dtype=torch.float32, device="cuda"))
    else:
        kw.update(warmup=24)
    got = fused_adaptive_hmc_sample(*args, **kw)
    ref = adaptive_hmc_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    for a, b in zip(got[3:5], ref[3:5]):
        assert float(_close(a, b).all(0).float().mean()) >= 0.999


@pytest.mark.parametrize("target", ["flagship", "corr2"])
@pytest.mark.parametrize("C,warmup,thin,n,offset,resume", [
    (4096, 40, 1, 24, 0, False), (4001, 10, 3, 11, (1 << 32) - 20, False),
    (4099, 0, 2, 20, 77, True),
])
def test_adapt_rwmh_kernel_matches_plain(model, target, C, warmup, thin, n, offset, resume):
    from advancedmh_tpu_torch.ops import (DualAveraging, adapt_rwmh_reference,
                                          fused_adapt_rwmh_sample)

    m = _slice3_model(model, target)
    p = _slice3_start(m, C, seed=C)
    lp = m.tile_density(p, *m.tile_consts)
    leb = (torch.full((1, C), -1.5, device="cuda") + 0.1 * torch.arange(C, device="cuda") / C
           if resume else None)
    args = (m.tile_density, m.cuda_density, p, lp, m.tile_consts, 51)
    kw = dict(warmup=warmup, thin=thin, n_samples=n, da=DualAveraging(10.0, 0.352),
              log_eps_bar=leb, iteration_offset=offset)
    before = fused_adapt_rwmh_sample.launches
    got = fused_adapt_rwmh_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_adapt_rwmh_sample.launches == before + 1
    ref = adapt_rwmh_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    assert float(_close(got[3], ref[3]).float().mean()) >= 0.999


@pytest.mark.parametrize("kernel", ["rwmh", "mala"])
def test_logistic_regression_yardsticks_match_plain(kernel):
    """The bench's hand-tuned RWMH (scale 0.45) and MALA (s² = 0.36)
    yardsticks at d = 32 and the main path's 8192 chains, 64 steps."""
    m = _logreg()
    p = _slice3_start(m, 8192, seed=2)
    if kernel == "rwmh":
        lp = m.tile_density(p, *m.tile_consts)
        args = (m.tile_density, m.cuda_density, p, lp, 0.45, m.tile_consts, 61)
        got = fused_rwmh_sample(*args, burn=0, thin=1, n_samples=64)
        ref = rwmh_sample_reference(*args, burn=0, thin=1, n_samples=64)
    else:
        lp, g = m.tile_value_and_grad(p, *m.tile_consts)
        args = (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 61)
        got = fused_mala_sample(*args, step_size_sq=0.36, burn=0, thin=1, n_samples=64)
        ref = mala_sample_reference(*args, step_size_sq=0.36, burn=0, thin=1, n_samples=64)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999


def test_constants_above_48_kb_launch():
    """A 300 x 32 logistic regression (38.7 KB) and a 400 x 32 one
    (51.3 KB, above the default dynamic shared memory) both launch."""
    from advancedmh_tpu_torch.models import logistic_regression_model

    for n_obs in (300, 400):
        m = logistic_regression_model(n_obs, 32, seed=1, device="cuda")
        p = torch.zeros(32, 256, device="cuda")
        lp = m.tile_density(p, *m.tile_consts)
        args = (m.tile_density, m.cuda_density, p, lp, 0.05, m.tile_consts, 3)
        got = fused_rwmh_sample(*args, burn=0, thin=1, n_samples=4)
        ref = rwmh_sample_reference(*args, burn=0, thin=1, n_samples=4)
        assert _agree(got, ref)[1] >= 0.99


def test_slice3_wrappers_raise_for_what_has_no_kernel(model):
    """An unknown tag, a missing tag, or a (tag, d) the library lacks raises
    _build.check's ValueError for the three slice-3 kernels."""
    from advancedmh_tpu_torch.ops import (fused_adapt_rwmh_sample, fused_adaptive_hmc_sample,
                                          fused_hmc_sample, minv_column)

    p, lp = _start(model, 64, seed=1)
    consts = model.tile_consts
    p3 = torch.zeros(3, 64, device="cuda")
    calls = {
        "adapt": lambda tag, x: fused_adapt_rwmh_sample(
            model.tile_density, tag, x, lp, consts, 1, warmup=1, thin=1, n_samples=2),
        "hmc": lambda tag, x: fused_hmc_sample(
            model.tile_value_and_grad, tag, x, lp, torch.zeros_like(x), consts, 1,
            step_size=0.1, n_leapfrog=2, inverse_mass=minv_column(None, x.shape[0], "cuda"),
            burn=0, thin=1, n_samples=2),
        "hmc_adapt": lambda tag, x: fused_adaptive_hmc_sample(
            model.tile_value_and_grad, tag, x, lp, torch.zeros_like(x), consts, 1,
            n_leapfrog=2, warmup=1, thin=1, n_samples=2),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA density tag"):
            call(None, p)
        with pytest.raises(ValueError, match="'banana'"):
            call("banana", p)
        with pytest.raises(ValueError, match="instantiates only"):
            call(model.cuda_density, p3)
        assert ("gaussian_mean_scale", 2) in _build.kernel_pairs(_build.library(), name)


# ---- slice 4: the ChEES warmup and frozen kernels, MEADS ---------------------------


def _slice4_model(model, target):
    from advancedmh_tpu_torch.models import neal_funnel_model

    return neal_funnel_model(10, device="cuda") if target == "funnel" else _slice3_model(
        model, target)


def _slice4_start(m, C, seed):
    if m.cuda_density == "neal_funnel":
        return _gauss_start(10, C, seed)
    return _slice3_start(m, C, seed)


def _chees_args(model, target, C, seed):
    m = _slice4_model(model, target)
    p = _slice4_start(m, C, seed)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    return m, (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 71 + seed)


def _bits_or_close(a, b):
    """Per chain: every entry equal, or within 1e-5 (NaN equal to NaN)."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) | _close(a, b)
    return same.reshape(-1, same.shape[-1]).all(0)


@pytest.mark.parametrize("target,C,tile", [
    ("flagship", 4096, 1024), ("corr2", 4001, 1024), ("logreg", 1024, 512), ("funnel", 2048, 1024),
])
def test_chees_warmup_kernel_matches_plain(model, target, C, tile):
    from advancedmh_tpu_torch import ChEESHMC
    from advancedmh_tpu_torch.ops import (CheesParams, chees_warmup_reference,
                                          fused_chees_warmup_block)

    m, args = _chees_args(model, target, C, seed=1)
    eps0 = {"flagship": 0.03, "corr2": 0.3, "logreg": 0.05, "funnel": 0.2}[target]
    spl = ChEESHMC(initial_step_size=eps0, max_leapfrog=16)
    sv = torch.tensor([np.log(eps0), np.log(eps0), 0, 0, 0, 0, 0, 1, 0], dtype=torch.float32,
                      device="cuda")
    kw = dict(trips=(5, 2, 8, 1), us=(0.5, 0.25, 0.75, 0.125), n_groups=16, sv=sv,
              inverse_mass=torch.ones(m.dimension, 1, device="cuda"),
              params=CheesParams.of(spl), tile_chains=tile, iteration_offset=3)
    before = fused_chees_warmup_block.launches
    got = fused_chees_warmup_block(*args, **kw)
    torch.cuda.synchronize()
    assert fused_chees_warmup_block.launches == before + 1
    ref = chees_warmup_reference(*args, **kw)
    for a, b in zip(got[:4], ref[:4]):  # x, lp, gradient, decisions
        assert float(_bits_or_close(a, b).float().mean()) >= 0.999
    for a, b in zip(got[4:], ref[4:]):  # the tiles' scalars and sums
        assert bool(_bits_or_close(a, b).all())


@pytest.mark.parametrize("target", ["flagship", "corr2", "logreg", "funnel"])
@pytest.mark.parametrize("per_chain_eps", [False, True])
def test_chees_frozen_kernel_matches_plain(model, target, per_chain_eps):
    from advancedmh_tpu_torch.ops import chees_frozen_reference, fused_chees_frozen_sample

    C = 8192 if target == "logreg" else 4000
    m, args = _chees_args(model, target, C, seed=2)
    eps = {"flagship": 0.03, "corr2": 0.4, "logreg": 0.05, "funnel": 0.2}[target]
    step = (eps * torch.linspace(0.5, 1.5, C, device="cuda")[None] if per_chain_eps
            else torch.full((1, 1), eps, device="cuda"))
    kw = dict(trips=(3, 5, 1, 7, 2, 6), phase=4, step_size=step,
              inverse_mass=torch.linspace(0.5, 1.5, m.dimension, device="cuda")[:, None],
              thin=2, n_samples=8, iteration_offset=(1 << 32) - 5)
    before = fused_chees_frozen_sample.launches
    got = fused_chees_frozen_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_chees_frozen_sample.launches == before + 1
    ref = chees_frozen_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999


@pytest.mark.parametrize("target,C,tile,K", [
    ("flagship", 4096, 1024, 4), ("corr2", 4000, 1024, 2), ("logreg", 2048, 1024, 2),
    ("funnel", 2048, 2048, 2),
    ("logreg", 8192, 8192, 2),  # 256 positions a block: the state stays in device memory
])
@pytest.mark.parametrize("accept", ["nonreversible", "metropolis"])
@pytest.mark.parametrize("precond", [True, False])
def test_meads_kernel_matches_plain(model, target, C, tile, K, accept, precond):
    from advancedmh_tpu_torch.ops import MeadsParams, fused_meads_sample, meads_reference

    m = _slice4_model(model, target)
    p0 = _slice4_start(m, C, seed=3)
    lp, g = m.tile_value_and_grad(p0, *m.tile_consts)
    rng = np.random.default_rng(4)
    mom = torch.tensor(rng.normal(size=(m.dimension, C)), dtype=torch.float32, device="cuda")
    u = torch.tensor(rng.uniform(size=(1, C)), dtype=torch.float32, device="cuda")
    args = (m.tile_value_and_grad, m.cuda_density, p0, lp, g, mom, u, m.tile_consts, 81)
    kw = dict(n_folds=K, t0=5, burn=3, thin=2, n_samples=12,
              params=MeadsParams(diagonal_preconditioning=precond, accept=accept),
              tile_chains=tile)
    before = fused_meads_sample.launches
    got = fused_meads_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_meads_sample.launches == before + 1
    ref = meads_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    for a, b in zip(got[3:], ref[3:]):  # the final x, lp, gradient, p, u
        assert float(_bits_or_close(a, b).float().mean()) >= 0.999


def _same_bits(a, b):
    """Every entry equal (NaN equal to NaN)."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def test_meads_kernel_at_65536_chains_matches_plain():
    """The cluster launch at a chain count the cooperative launch refused:
    64 tiles of 1024 on the logistic regression, 16 blocks a cluster."""
    from advancedmh_tpu_torch.ops import MeadsParams, fused_meads_sample, meads_reference
    from advancedmh_tpu_torch.ops.meads import cluster_ctas
    from advancedmh_tpu_torch.runtime.fused import MAX_TILE, MEADS_BUDGET, fused_tile

    m, C = _logreg(), 65536
    tile = fused_tile(C, MAX_TILE, 32, MEADS_BUDGET)
    assert (tile, cluster_ctas(tile, 2)) == (1024, 16)
    p0 = _slice3_start(m, C, seed=5)
    lp, g = m.tile_value_and_grad(p0, *m.tile_consts)
    rng = np.random.default_rng(6)
    mom = torch.tensor(rng.normal(size=(32, C)), dtype=torch.float32, device="cuda")
    u = torch.tensor(rng.uniform(size=(1, C)), dtype=torch.float32, device="cuda")
    args = (m.tile_value_and_grad, m.cuda_density, p0, lp, g, mom, u, m.tile_consts, 85)
    kw = dict(n_folds=2, t0=1, burn=1, thin=1, n_samples=3, params=MeadsParams(),
              tile_chains=tile)
    before = fused_meads_sample.launches
    got = fused_meads_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_meads_sample.launches == before + 1
    ref = meads_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    for a, b in zip(got[3:], ref[3:]):
        assert float(_bits_or_close(a, b).float().mean()) >= 0.999


@pytest.mark.parametrize("C", [8190, 100])
@pytest.mark.parametrize("resume", [False, True])
def test_adaptive_hmc_group_kernel_is_bit_exact(C, resume):
    """The logistic regression's 8-lane group kernel on chain counts that are
    not a multiple of its 16-chain blocks, fresh and resumed, thin 3: every
    output equal to the plain version's bits."""
    from advancedmh_tpu_torch.ops import (DualAveraging, adaptive_hmc_reference,
                                          fused_adaptive_hmc_sample)

    m = _logreg()
    p = _slice3_start(m, C, seed=C)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    args = (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 43)
    kw = dict(n_leapfrog=8, thin=3, n_samples=5, da=DualAveraging(0.05, 0.65),
              iteration_offset=21)
    if resume:
        rng = np.random.default_rng(C + 1)
        kw.update(warmup=0,
                  log_eps_bar=torch.tensor(np.log(rng.uniform(0.5, 1.5, (1, C)) * 0.02),
                                           dtype=torch.float32, device="cuda"),
                  inverse_mass=torch.tensor(rng.uniform(0.5, 2.0, (32, C)),
                                            dtype=torch.float32, device="cuda"))
    else:
        kw.update(warmup=12)
    before = fused_adaptive_hmc_sample.launches
    got = fused_adaptive_hmc_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_adaptive_hmc_sample.launches == before + 1
    ref = adaptive_hmc_reference(*args, **kw)
    for a, b in zip(got, ref):  # draws, lps, decisions, log ε̄, M⁻¹, final gradient
        assert _same_bits(a, b)


@pytest.mark.parametrize("kernel", ["adaptive_hmc", "hmc", "chees_frozen"])
@pytest.mark.parametrize("target", ["flagship", "logreg"])
def test_group_kernel_launch_shape(model, kernel, target):
    """The three kernels on csrc/hmc_group.cuh: 16 chains of 8 lanes in
    128-thread blocks, 4 resident an SM, on the logistic regression; 64
    chains of one thread on the flagship."""
    from advancedmh_tpu_torch.ops.chees import chees_frozen_launch_info
    from advancedmh_tpu_torch.ops.hmc import hmc_launch_info
    from advancedmh_tpu_torch.ops.hmc_adapt import adaptive_hmc_launch_info
    from advancedmh_tpu_torch.ops._build import flat_consts

    m = _slice3_model(model, target)
    launch_info = {"adaptive_hmc": adaptive_hmc_launch_info, "hmc": hmc_launch_info,
                   "chees_frozen": chees_frozen_launch_info}[kernel]
    info = launch_info(m.cuda_density, m.dimension, flat_consts(m.tile_consts, "cuda")[1], 8190)
    lanes, threads = (8, 128) if target == "logreg" else (1, 64)
    assert info["lanes_per_chain"] == lanes and info["threads"] == threads
    assert info["chains_per_block"] * lanes == threads
    assert info["blocks"] == -(-8190 // info["chains_per_block"])
    assert info["blocks_per_sm"] >= (4 if target == "logreg" else 1)


def _assert_split_resumes(whole, first, rest):
    """A run split after ``first``'s draws and resumed from its last state
    (``rest``) gives the whole run's draws, lps, decisions and final gradient."""
    for a, b, c in zip(whole[:3], first[:3], rest[:3]):
        assert _same_bits(a, torch.cat([b, c]))
    assert _same_bits(whole[3], rest[3])


@pytest.mark.parametrize("C", [8190, 100])
def test_hmc_group_kernel_is_bit_exact(C):
    """HMC on the logistic regression's 8-lane group kernel on chain counts
    that are not a multiple of its 16-chain blocks, burn 5, thin 3, offsets
    near 2**32: every output equal to the plain version's bits, and a run
    split in two and resumed equal to the whole run."""
    from advancedmh_tpu_torch.ops import fused_hmc_sample, hmc_sample_reference, minv_column

    m = _logreg()
    p = _slice3_start(m, C, seed=C + 2)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    vg, consts, seed = m.tile_value_and_grad, m.tile_consts, 47
    offset = (1 << 32) - 20
    kw = dict(step_size=0.05, n_leapfrog=8, thin=3,
              inverse_mass=minv_column(torch.linspace(0.5, 1.5, 32), 32, "cuda"))
    before = fused_hmc_sample.launches
    got = fused_hmc_sample(vg, m.cuda_density, p, lp, g, consts, seed, burn=5, n_samples=6,
                           iteration_offset=offset, **kw)
    torch.cuda.synchronize()
    assert fused_hmc_sample.launches == before + 1
    ref = hmc_sample_reference(vg, m.cuda_density, p, lp, g, consts, seed, burn=5,
                               n_samples=6, iteration_offset=offset, **kw)
    for a, b in zip(got, ref):  # draws, lps, decisions, final gradient
        assert _same_bits(a, b)
    first = fused_hmc_sample(vg, m.cuda_density, p, lp, g, consts, seed, burn=5, n_samples=2,
                             iteration_offset=offset, **kw)
    rest = fused_hmc_sample(vg, m.cuda_density, first[0][-1].contiguous(),
                            first[1][-1].contiguous(), first[3], consts, seed, burn=0,
                            n_samples=4, iteration_offset=offset + 5 + 2 * 3, **kw)
    _assert_split_resumes(got, first, rest)


@pytest.mark.parametrize("target,C", [("logreg", 8190), ("logreg", 100), ("funnel", 4001)])
@pytest.mark.parametrize("per_chain_eps", [False, True])
def test_chees_frozen_group_kernel_is_bit_exact(model, target, C, per_chain_eps):
    """ChEES's frozen phase on the logistic regression's 8-lane group kernel
    (chain counts not a multiple of its 16-chain blocks) and on the funnel at
    one thread a chain, thin 3, phase 4, offsets near 2**32, one ε̄ or one
    per chain: every output equal to the plain version's bits, and a run
    split in two and resumed equal to the whole run."""
    from advancedmh_tpu_torch.ops import chees_frozen_reference, fused_chees_frozen_sample

    m, args = _chees_args(model, target, C, seed=C)
    eps = {"logreg": 0.05, "funnel": 0.2}[target]
    step = (eps * torch.linspace(0.5, 1.5, C, device="cuda")[None] if per_chain_eps
            else torch.full((1, 1), eps, device="cuda"))
    trips, phase, offset = (3, 5, 1, 7, 2, 6), 4, (1 << 32) - 7
    kw = dict(trips=trips, step_size=step, thin=3,
              inverse_mass=torch.linspace(0.5, 1.5, m.dimension, device="cuda")[:, None])
    before = fused_chees_frozen_sample.launches
    got = fused_chees_frozen_sample(*args, phase=phase, n_samples=6, iteration_offset=offset,
                                    **kw)
    torch.cuda.synchronize()
    assert fused_chees_frozen_sample.launches == before + 1
    ref = chees_frozen_reference(*args, phase=phase, n_samples=6, iteration_offset=offset, **kw)
    for a, b in zip(got, ref):  # draws, lps, decisions, final gradient
        assert _same_bits(a, b)
    vg, dens, _, _, _, consts, seed = args
    first = fused_chees_frozen_sample(*args, phase=phase, n_samples=2, iteration_offset=offset,
                                      **kw)
    rest = fused_chees_frozen_sample(vg, dens, first[0][-1].contiguous(),
                                     first[1][-1].contiguous(), first[3], consts, seed,
                                     phase=phase + 2 * 3, n_samples=4,
                                     iteration_offset=offset + 2 * 3, **kw)
    _assert_split_resumes(got, first, rest)


def test_slice4_wrappers_raise_for_what_has_no_kernel(model):
    """An unknown tag, a missing tag, or a (tag, d) the library lacks raises
    _build.check's ValueError for the three slice-4 kernels."""
    from advancedmh_tpu_torch import ChEESHMC
    from advancedmh_tpu_torch.ops import (CheesParams, MeadsParams, fused_chees_frozen_sample,
                                          fused_chees_warmup_block, fused_meads_sample)

    p, lp = _start(model, 64, seed=1)
    consts = model.tile_consts
    p3 = torch.zeros(3, 64, device="cuda")
    vg = model.tile_value_and_grad
    calls = {
        "warmup": lambda tag, x: fused_chees_warmup_block(
            vg, tag, x, lp, torch.zeros_like(x), consts, 1, trips=(1,), us=(0.5,), n_groups=1,
            sv=torch.zeros(9, device="cuda"), inverse_mass=torch.ones(x.shape[0], 1, device="cuda"),
            params=CheesParams.of(ChEESHMC()), tile_chains=64),
        "frozen": lambda tag, x: fused_chees_frozen_sample(
            vg, tag, x, lp, torch.zeros_like(x), consts, 1, trips=(1,), phase=0,
            step_size=torch.full((1, 1), 0.1, device="cuda"),
            inverse_mass=torch.ones(x.shape[0], 1, device="cuda"), thin=1, n_samples=2),
        "meads": lambda tag, x: fused_meads_sample(
            vg, tag, x, lp, torch.zeros_like(x), torch.zeros_like(x), torch.zeros_like(lp),
            consts, 1, n_folds=2, t0=1, burn=0, thin=1, n_samples=2, params=MeadsParams(),
            tile_chains=64),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA density tag"):
            call(None, p)
        with pytest.raises(ValueError, match="'banana'"):
            call("banana", p)
        with pytest.raises(ValueError, match="instantiates only"):
            call(model.cuda_density, p3)
    for kernel in ("chees", "meads"):
        pairs = _build.kernel_pairs(_build.library(), kernel)
        assert {("logistic_regression", 32), ("neal_funnel", 10)} <= pairs


# ---- slice 5: slice sampling, elliptical slice, Barker, pCN ------------------------


def _gp(d, lik):
    from advancedmh_tpu_torch.models import gp_latent_model

    return gp_latent_model(d, likelihood=lik, seed=5, device="cuda")


@pytest.mark.parametrize("target,width", [("flagship", 0.5), ("corr2", 1.5), ("funnel", 3.0)])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (2048, 0, 1, 32, 0), (2001, 5, 3, 11, (1 << 32) - 20),
])
def test_slice_kernel_matches_plain(model, target, width, C, burn, thin, n, offset):
    from advancedmh_tpu_torch.ops import fused_slice_sample, slice_sample_reference

    m = _slice4_model(model, target)
    p = _slice4_start(m, C, seed=C)
    lp = m.tile_density(p, *m.tile_consts)
    args = (m.tile_density, m.cuda_density, p, lp, m.tile_consts, 91)
    kw = dict(width=width, max_stepout=8, max_shrink=24, burn=burn, thin=thin, n_samples=n,
              iteration_offset=offset)
    before = fused_slice_sample.launches
    got = fused_slice_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_slice_sample.launches == before + 1
    dec, chains = _agree(got, slice_sample_reference(*args, **kw))
    assert dec >= 0.999 and chains >= 0.999


@pytest.mark.parametrize("lik", ["gaussian", "logistic"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("tril", [True, False])
@pytest.mark.parametrize("kernel", ["ess", "pcn"])
def test_prior_kernels_match_plain(lik, d, tril, kernel):
    from advancedmh_tpu_torch.ops import (ess_sample_reference, fused_ess_sample,
                                          fused_pcn_sample, pcn_sample_reference)

    m, prior, _ = _gp(d, lik)
    C = 1024
    x = (prior.scale_tril @ torch.randn(d, C, device="cuda",
                                        generator=torch.Generator("cuda").manual_seed(d)))
    lp = m.tile_density(x, *m.tile_consts)
    scale = prior.scale_tril if tril else torch.linspace(0.5, 1.5, d, device="cuda")
    args = (m.tile_density, m.cuda_density, x.contiguous(), lp, torch.zeros(d, device="cuda"),
            scale, m.tile_consts, 93)
    common = dict(burn=3, thin=2, n_samples=16, iteration_offset=(1 << 32) - 7)
    if kernel == "ess":
        fused, plain, kw = fused_ess_sample, ess_sample_reference, dict(max_shrink=24, **common)
    else:
        fused, plain, kw = fused_pcn_sample, pcn_sample_reference, dict(beta=0.2, **common)
    before = fused.launches
    got = fused(*args, **kw)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    dec, chains = _agree(got, plain(*args, **kw))
    assert dec >= 0.999 and chains >= 0.999


@pytest.mark.parametrize("target,eps", [("flagship", 0.05), ("corr2", 0.9), ("logreg", 0.05)])
def test_barker_kernel_matches_plain(model, target, eps):
    from advancedmh_tpu_torch.ops import barker_sample_reference, fused_barker_sample

    m = _slice3_model(model, target)
    C = 8192 if target == "logreg" else 4000
    p = _slice3_start(m, C, seed=9)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    args = (m.tile_value_and_grad, m.cuda_density, p, lp, g, m.tile_consts, 95)
    kw = dict(step_size=eps, burn=2, thin=2, n_samples=16, iteration_offset=11)
    before = fused_barker_sample.launches
    got = fused_barker_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_barker_sample.launches == before + 1
    ref = barker_sample_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    assert float(_bits_or_close(got[3], ref[3]).float().mean()) >= 0.999


def test_slice5_wrappers_raise_for_what_has_no_kernel(model):
    """An unknown tag, a missing tag, or a (tag, d) the library lacks raises
    _build.check's ValueError for the four slice-5 kernels."""
    from advancedmh_tpu_torch.ops import (fused_barker_sample, fused_ess_sample,
                                          fused_pcn_sample, fused_slice_sample)

    p, lp = _start(model, 64, seed=1)
    consts = model.tile_consts
    p3 = torch.zeros(3, 64, device="cuda")
    z = lambda x: torch.zeros(x.shape[0], device="cuda")
    o = lambda x: torch.ones(x.shape[0], device="cuda")
    calls = {
        "slice": lambda tag, x: fused_slice_sample(
            model.tile_density, tag, x, lp, consts, 1, width=1.0, max_stepout=4, max_shrink=4,
            burn=0, thin=1, n_samples=2),
        "ess": lambda tag, x: fused_ess_sample(
            model.tile_density, tag, x, lp, z(x), o(x), consts, 1, max_shrink=4, burn=0,
            thin=1, n_samples=2),
        "barker": lambda tag, x: fused_barker_sample(
            model.tile_value_and_grad, tag, x, lp, torch.zeros_like(x), consts, 1,
            step_size=0.1, burn=0, thin=1, n_samples=2),
        "pcn": lambda tag, x: fused_pcn_sample(
            model.tile_density, tag, x, lp, z(x), o(x), consts, 1, beta=0.2, burn=0, thin=1,
            n_samples=2),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA density tag"):
            call(None, p)
        with pytest.raises(ValueError, match="'banana'"):
            call("banana", p)
        with pytest.raises(ValueError, match="instantiates only"):
            call(model.cuda_density if name in ("slice", "barker") else "gp_regression", p3)
    pairs = {k: _build.kernel_pairs(_build.library(), k) for k in ("slice", "ess", "barker", "pcn")}
    assert ("neal_funnel", 10) in pairs["slice"] and ("logistic_regression", 32) in pairs["barker"]
    assert {("gp_regression", 64), ("gp_classification", 16)} <= pairs["ess"] & pairs["pcn"]


def _gp_args(lik, d, tril, C, seed):
    """A GP likelihood, starts drawn from its prior, a prior mean off zero,
    and the prior's factor (tril) or a diagonal scale."""
    m, prior, _ = _gp(d, lik)
    gen = torch.Generator("cuda").manual_seed(seed)
    x = (prior.scale_tril @ torch.randn(d, C, device="cuda", generator=gen)).contiguous()
    loc = torch.linspace(-0.2, 0.2, d, device="cuda")
    scale = prior.scale_tril if tril else torch.linspace(0.5, 1.5, d, device="cuda")
    return m, (m.tile_density, m.cuda_density, x, m.tile_density(x, *m.tile_consts), loc,
               scale, m.tile_consts, seed)


@pytest.mark.parametrize("C", [8190, 100])
@pytest.mark.parametrize("lik", ["gaussian", "logistic"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("tril", [True, False])
def test_ess_group_kernel_is_bit_exact(C, lik, d, tril):
    """ESS on 8 lanes a chain (the GP likelihoods' group form) at every
    instantiated pair, on chain counts that are not a multiple of its
    16-chain blocks, burn 5, thin 3, offsets near 2**32: every output equal
    to the plain version's bits (the points summed in 8 interleaved
    partials), and a run split in two and resumed equal to the whole run."""
    from advancedmh_tpu_torch.ops import ess_sample_reference, fused_ess_sample

    _, args = _gp_args(lik, d, tril, C, seed=97 + d)
    offset = (1 << 32) - 9
    kw = dict(max_shrink=24, thin=3)
    before = fused_ess_sample.launches
    got = fused_ess_sample(*args, burn=5, n_samples=6, iteration_offset=offset, **kw)
    torch.cuda.synchronize()
    assert fused_ess_sample.launches == before + 1
    ref = ess_sample_reference(*args, burn=5, n_samples=6, iteration_offset=offset, **kw)
    for a, b in zip(got, ref):  # draws, lps, decisions
        assert _same_bits(a, b)
    tile, dens, _, _, loc, scale, consts, seed = args
    first = fused_ess_sample(*args, burn=5, n_samples=2, iteration_offset=offset, **kw)
    rest = fused_ess_sample(tile, dens, first[0][-1].contiguous(), first[1][-1].contiguous(),
                            loc, scale, consts, seed, burn=0, n_samples=4,
                            iteration_offset=offset + 5 + 2 * 3, **kw)
    for a, b, c in zip(got, first, rest):
        assert _same_bits(a, torch.cat([b, c]))


@pytest.mark.parametrize("C", [2000, 8190, 100])
@pytest.mark.parametrize("lik", ["gaussian", "logistic"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("tril", [True, False])
def test_pcn_kernel_is_bit_exact_in_the_gp_order(C, lik, d, tril):
    """pCN on 8 lanes a chain (ESS's prior draw, csrc/gp_group.cuh) at every
    instantiated pair, the points summed in the 8 interleaved partials of
    the group form, on chain counts that are not a multiple of its 16-chain
    blocks: every output equal to the plain version's bits, and a run split
    in two and resumed through its draws and lp equal to the whole run."""
    from advancedmh_tpu_torch.ops import fused_pcn_sample, pcn_sample_reference

    _, args = _gp_args(lik, d, tril, C, seed=131 + d)
    offset = (1 << 32) - 7
    kw = dict(beta=0.2, thin=2)
    before = fused_pcn_sample.launches
    got = fused_pcn_sample(*args, burn=3, n_samples=16, iteration_offset=offset, **kw)
    torch.cuda.synchronize()
    assert fused_pcn_sample.launches == before + 1
    ref = pcn_sample_reference(*args, burn=3, n_samples=16, iteration_offset=offset, **kw)
    for a, b in zip(got, ref):  # draws, lps, decisions
        assert _same_bits(a, b)
    tile, dens, _, _, loc, scale, consts, seed = args
    first = fused_pcn_sample(*args, burn=3, n_samples=5, iteration_offset=offset, **kw)
    rest = fused_pcn_sample(tile, dens, first[0][-1].contiguous(), first[1][-1].contiguous(),
                            loc, scale, consts, seed, burn=0, n_samples=11,
                            iteration_offset=offset + 3 + 5 * 2, **kw)
    for a, b, c in zip(got, first, rest):
        assert _same_bits(a, torch.cat([b, c]))


@pytest.mark.parametrize("target,C", [("logreg", 8190), ("logreg", 100), ("flagship", 4001),
                                      ("corr2", 4001)])
def test_barker_group_kernel_is_bit_exact(model, target, C):
    """Barker on the logistic regression's 8-lane group step (chain counts
    not a multiple of its 16-chain blocks) and on the d = 2 targets at one
    thread a chain, burn 5, thin 3, offsets near 2**32: every output equal
    to the plain version's bits, the final gradient included, and a run
    split in two and resumed equal to the whole run."""
    from advancedmh_tpu_torch.ops import barker_sample_reference, fused_barker_sample

    m = _slice3_model(model, target)
    p = _slice3_start(m, C, seed=C + 5)
    lp, g = m.tile_value_and_grad(p, *m.tile_consts)
    vg, consts, seed = m.tile_value_and_grad, m.tile_consts, 53
    offset = (1 << 32) - 20
    kw = dict(step_size={"logreg": 0.05, "flagship": 0.05, "corr2": 0.9}[target], thin=3)
    before = fused_barker_sample.launches
    got = fused_barker_sample(vg, m.cuda_density, p, lp, g, consts, seed, burn=5, n_samples=6,
                              iteration_offset=offset, **kw)
    torch.cuda.synchronize()
    assert fused_barker_sample.launches == before + 1
    ref = barker_sample_reference(vg, m.cuda_density, p, lp, g, consts, seed, burn=5,
                                  n_samples=6, iteration_offset=offset, **kw)
    for a, b in zip(got, ref):  # draws, lps, decisions, final gradient
        assert _same_bits(a, b)
    first = fused_barker_sample(vg, m.cuda_density, p, lp, g, consts, seed, burn=5,
                                n_samples=2, iteration_offset=offset, **kw)
    rest = fused_barker_sample(vg, m.cuda_density, first[0][-1].contiguous(),
                               first[1][-1].contiguous(), first[3], consts, seed, burn=0,
                               n_samples=4, iteration_offset=offset + 5 + 2 * 3, **kw)
    _assert_split_resumes(got, first, rest)


@pytest.mark.parametrize("kernel,target,lanes", [
    ("barker", "logreg", 8), ("barker", "flagship", 1), ("ess", "gaussian", 8),
    ("ess", "logistic", 8),
])
@pytest.mark.parametrize("tril", [True, False])
def test_barker_and_ess_launch_shape(model, kernel, target, lanes, tril):
    """Barker on csrc/hmc_group.cuh's blocks (16 chains of 8 lanes, 4
    resident an SM, on the logistic regression; 64 chains of one thread on
    the flagship) and ESS on the GP likelihoods' 8 lanes a chain, 16 chains
    a block, at least 4 resident an SM, with either prior scale."""
    from advancedmh_tpu_torch.ops.barker import barker_launch_info
    from advancedmh_tpu_torch.ops.ess import ess_launch_info
    from advancedmh_tpu_torch.ops._build import flat_consts

    if kernel == "barker":
        m = _slice3_model(model, target)
        info = barker_launch_info(m.cuda_density, m.dimension,
                                  flat_consts(m.tile_consts, "cuda")[1], 8190)
    else:
        m, _, _ = _gp(64, target)
        info = ess_launch_info(m.cuda_density, 64, tril, flat_consts(m.tile_consts, "cuda")[1],
                               8190)
    threads = 128 if lanes == 8 else 64
    assert info["lanes_per_chain"] == lanes and info["threads"] == threads
    assert info["chains_per_block"] * lanes == threads
    assert info["blocks"] == -(-8190 // info["chains_per_block"])
    assert info["blocks_per_sm"] >= (4 if lanes == 8 else 1)


def _ptxas_report(tmp_path, source, n_kernels):
    """ptxas' report for every kernel of the source, which spills nothing:
    (mangled name, registers) of each kernel."""
    import re
    import subprocess

    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                        str(tmp_path / "k.o"), str(_build.CSRC_DIR / source)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    report = r.stdout + r.stderr
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
    assert len(spills) >= n_kernels, report
    assert all(a == "0" and b == "0" for a, b in spills), report
    return re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers", report,
                      re.S)


@pytest.mark.parametrize("source,n_kernels", [("barker.cu", 3), ("ess.cu", 8)])
def test_barker_and_ess_do_not_spill(tmp_path, source, n_kernels):
    """ptxas' report for every kernel of the source: no spill stores or
    loads (one thread a chain spilled 456 B on Barker's logistic regression,
    and ESS's d = 64 kernels at 255 registers)."""
    _ptxas_report(tmp_path, source, n_kernels)


@pytest.mark.parametrize("source,n_kernels", [("evidence.cu", 6), ("pcn.cu", 8)])
def test_evidence_and_pcn_do_not_spill(tmp_path, source, n_kernels):
    """ptxas' report for every kernel of the source: no spills, and at most
    128 registers in every kernel on 8 lanes a chain (the logistic
    regression's evidence kernels, every pCN kernel), so that 4 blocks of
    128 threads fit an SM (one thread a chain held pCN's d = 64 state at
    203-214 registers)."""
    kernels = _ptxas_report(tmp_path, source, n_kernels)
    lanes8 = [(name, int(regs)) for name, regs in kernels
              if "LogisticRegression" in name or source == "pcn.cu"]
    assert len(lanes8) == (2 if source == "evidence.cu" else 8), kernels
    assert all(regs <= 128 for _, regs in lanes8), kernels


@pytest.mark.parametrize("kernel,target", [("evidence", "logreg"), ("evidence", "conjugate"),
                                           ("pcn", "gaussian"), ("pcn", "logistic")])
@pytest.mark.parametrize("flag", [True, False])
def test_evidence_and_pcn_launch_shape(kernel, target, flag):
    """The evidence kernel (``flag`` adapt) on the logistic regression's 8
    lanes a chain and pCN (``flag`` tril) on the d = 64 GP likelihoods' 8
    lanes: 16 chains a 128-thread block, at least 4 resident an SM; the
    conjugate likelihood 64 chains of one thread a block."""
    from advancedmh_tpu_torch.ops.evidence import evidence_launch_info
    from advancedmh_tpu_torch.ops.pcn import pcn_launch_info
    from advancedmh_tpu_torch.ops._build import flat_consts

    if kernel == "evidence":
        m = _evidence_inputs(target, 64, 0)[0]
        info = evidence_launch_info(m.cuda_density, m.dimension, flag,
                                    flat_consts(m.tile_consts, "cuda")[1], 8190)
        lanes = 8 if target == "logreg" else 1
    else:
        m, _, _ = _gp(64, target)
        info = pcn_launch_info(m.cuda_density, 64, flag, flat_consts(m.tile_consts, "cuda")[1],
                               8190)
        lanes = 8
    threads = 128 if lanes == 8 else 64
    assert info["lanes_per_chain"] == lanes and info["threads"] == threads
    assert info["chains_per_block"] * lanes == threads
    assert info["blocks"] == -(-8190 // info["chains_per_block"])
    assert info["blocks_per_sm"] >= (4 if lanes == 8 else 1)


# ---- slice 6: Adaptive Metropolis, delayed rejection, DRAM ---------------------------


def _slice6_model(model, target):
    from advancedmh_tpu_torch.models import banana_model

    if target == "banana":
        return banana_model(device="cuda")
    if target in ("corr4", "corr8"):
        d = int(target[-1])
        return correlated_gaussian_model(0.5 * np.ones((d, d)) + 0.5 * np.eye(d), device="cuda")
    if target == "flag300":
        return gaussian_mean_scale_model(n_obs=300, device="cuda")
    return _slice3_model(model, target)


def _am_inputs(m, C, seed, resumed):
    """x, lp and the moments (mean, L, n): fresh (mean x, L = (0.1/√d) I,
    n = 1) or resumed (a random lower factor, n = 5000)."""
    d = m.dimension
    rng = np.random.default_rng(seed)
    x = _slice3_start(m, C, seed)
    if resumed:
        L = np.tril(rng.normal(0.0, 0.3, (C, d, d)), -1)
        L[:, np.arange(d), np.arange(d)] = rng.uniform(0.5, 1.5, (C, d))
        L = torch.tensor(L.reshape(C, d * d).T, dtype=torch.float32, device="cuda").contiguous()
        mean = torch.tensor(rng.normal(0.0, 0.1, (d, C)), dtype=torch.float32, device="cuda")
        n = torch.full((1, C), 5000.0, device="cuda")
    else:
        L = (0.1 / np.sqrt(d) * torch.eye(d, device="cuda")).reshape(d * d, 1).expand(d * d, C)
        mean, n = x.clone(), torch.ones(1, C, device="cuda")
    return x, m.tile_density(x, *m.tile_consts), mean, L.contiguous(), n


@pytest.mark.parametrize("kernel", ["am", "dram"])
@pytest.mark.parametrize("target,resumed", [
    ("corr2", False), ("corr4", True), ("corr8", False), ("corr8", True), ("banana", False),
])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (2048, 0, 1, 32, 0), (2001, 5, 3, 11, (1 << 32) - 20),
])
def test_am_family_kernels_match_plain(model, kernel, target, resumed, C, burn, thin, n, offset):
    """AM and DRAM: states, lp, decisions and the final (mean, L, n)."""
    from advancedmh_tpu_torch.ops import (am_sample_reference, dram_sample_reference,
                                          fused_am_sample, fused_dram_sample)

    fused, plain = ((fused_am_sample, am_sample_reference) if kernel == "am"
                    else (fused_dram_sample, dram_sample_reference))
    m = _slice6_model(model, target)
    args = (m.tile_density, m.cuda_density, *_am_inputs(m, C, C + 6, resumed), m.tile_consts, 96)
    kw = dict(burn=burn, thin=thin, n_samples=n, iteration_offset=offset)
    before = fused.launches
    got = fused(*args, **kw)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    ref = plain(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    for f, f_r in zip(got[3:], ref[3:]):
        assert float(_bits_or_close(f, f_r).float().mean()) >= 0.999
    assert bool((got[5] == 1 + burn + n * thin).all()) or resumed


@pytest.mark.parametrize("target,s1,s2", [
    ("flagship", 0.5, 0.1), ("flag300", 8.0, 0.15), ("banana", [3.0, 1.0], [0.6, 0.2]),
])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (2048, 0, 1, 32, 0), (2001, 5, 3, 11, (1 << 32) - 20),
])
def test_dr_kernel_matches_plain(model, target, s1, s2, C, burn, thin, n, offset):
    from advancedmh_tpu_torch.ops import dr_sample_reference, fused_dr_sample

    m = _slice6_model(model, target)
    p = _slice3_start(m, C, seed=C + 7)
    args = (m.tile_density, m.cuda_density, p, m.tile_density(p, *m.tile_consts),
            torch.tensor(s1, device="cuda"), torch.tensor(s2, device="cuda"), m.tile_consts, 97)
    kw = dict(burn=burn, thin=thin, n_samples=n, iteration_offset=offset)
    before = fused_dr_sample.launches
    got = fused_dr_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_dr_sample.launches == before + 1
    dec, chains = _agree(got, dr_sample_reference(*args, **kw))
    assert dec >= 0.999 and chains >= 0.999


def test_slice6_wrappers_raise_for_what_has_no_kernel(model):
    """An unknown tag, a missing tag, or a (tag, d) the library lacks raises
    _build.check's ValueError for the three slice-6 kernels; d > 8 for AM and
    DRAM raises before any launch."""
    from advancedmh_tpu_torch.ops import fused_am_sample, fused_dr_sample, fused_dram_sample

    def am_call(fn):
        def call(tag, x):
            d, C = x.shape
            L = torch.eye(d, device="cuda").reshape(d * d, 1).expand(d * d, C).contiguous()
            return fn(model.tile_density, tag, x, torch.zeros(1, C, device="cuda"), x.clone(), L,
                      torch.ones(1, C, device="cuda"), model.tile_consts, 1, burn=0, thin=1,
                      n_samples=2)
        return call

    calls = {
        "am": am_call(fused_am_sample),
        "dram": am_call(fused_dram_sample),
        "dr": lambda tag, x: fused_dr_sample(
            model.tile_density, tag, x, torch.zeros(1, x.shape[1], device="cuda"),
            torch.ones(x.shape[0], device="cuda"), torch.ones(x.shape[0], device="cuda"),
            model.tile_consts, 1, burn=0, thin=1, n_samples=2),
    }
    p = torch.zeros(2, 64, device="cuda")
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA density tag"):
            call(None, p)
        with pytest.raises(ValueError, match="'emcee_demo'"):
            call("emcee_demo", p)
        with pytest.raises(ValueError, match="instantiates only"):
            call("correlated_gaussian", torch.zeros(3, 64, device="cuda"))
        pairs = _build.kernel_pairs(_build.library(), name)
        assert {("banana", 2), ("gaussian_mean_scale", 2), ("correlated_gaussian", 2)} <= pairs
    for name in ("am", "dram"):
        with pytest.raises(ValueError, match="d <= 8"):
            calls[name]("correlated_gaussian", torch.zeros(9, 64, device="cuda"))
        assert ("correlated_gaussian", 8) in _build.kernel_pairs(_build.library(), name)


# ---- slice 7: Multiple-Try Metropolis, replica exchange and DE-MC --------------------


def _slice7_model(model, target):
    from advancedmh_tpu_torch.models import bimodal_mixture_model

    if target == "bimodal":
        return bimodal_mixture_model(device="cuda")
    if target == "emcee":
        return emcee_demo_model(device="cuda")
    return _slice6_model(model, target)


@pytest.mark.parametrize("target,scale", [
    ("flagship", [0.2, 0.2]), ("flagship", [[0.2, 0.0], [0.05, 0.15]]), ("corr2", [0.8, 0.6]),
    ("corr4", [0.5] * 4),
])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (4096, 0, 1, 64, 0), (2001, 5, 3, 11, (1 << 32) - 20),
])
def test_mtm_sample_kernel_matches_plain(model, target, scale, k, C, burn, thin, n, offset):
    from advancedmh_tpu_torch.ops import fused_mtm_sample, mtm_sample_reference

    m = _slice7_model(model, target)
    p = _slice3_start(m, C, seed=C + 8)
    args = (m.tile_density, m.cuda_density, p, m.tile_density(p, *m.tile_consts),
            torch.tensor(scale, device="cuda"), m.tile_consts, 98)
    kw = dict(k=k, burn=burn, thin=thin, n_samples=n, iteration_offset=offset)
    before = fused_mtm_sample.launches
    got = fused_mtm_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_mtm_sample.launches == before + 1
    dec, chains = _agree(got, mtm_sample_reference(*args, **kw))
    assert dec >= 0.999 and chains >= 0.999


@pytest.mark.parametrize("k,n_steps", [(1, 1), (3, 40), (8, 17)])
def test_mtm_step_kernel_matches_plain(model, k, n_steps):
    from advancedmh_tpu_torch.ops import fused_mtm, mtm_reference

    p, lp = _start(model, 4000, seed=k)
    args = (model.tile_density, model.cuda_density, p, lp, torch.tensor([0.2, 0.2], device="cuda"),
            model.tile_consts, 99)
    before = fused_mtm.launches
    x, l, acc = fused_mtm(*args, k=k, n_steps=n_steps, iteration_offset=3)
    torch.cuda.synchronize()
    assert fused_mtm.launches == before + 1
    x_r, l_r, acc_r = mtm_reference(*args, k=k, n_steps=n_steps, iteration_offset=3)
    ok = (acc == acc_r)[0] & _close(x, x_r).all(0) & _close(l, l_r)[0]
    assert float(ok.float().mean()) >= 0.999


@pytest.mark.parametrize("target,betas,scale,rs", [
    ("flagship", (1.0, 0.5, 0.25, 0.1), 0.3, None),
    ("bimodal", (1.0, 0.55, 0.3, 0.15, 0.05), 0.5, None),
    ("bimodal", (1.0, 0.3), 0.5, (1.0, 2.0)),
    ("corr2", (1.0, 0.6, 0.3), [0.8, 0.5], (1.0, 1.3, 1.8)),
])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (4096, 0, 1, 64, 0), (2001, 5, 3, 11, (1 << 32) - 20),
])
def test_tempering_kernel_matches_plain(model, target, betas, scale, rs, C, burn, thin, n,
                                        offset):
    """The cold replica's draws, lp and decisions, and per chain the final
    ladder, its ℓ and the swap counts (the flagship's starts outside the
    support, ℓ = −inf, among them: no NaN)."""
    from advancedmh_tpu_torch.ops import fused_tempering_sample, tempering_sample_reference

    m = _slice7_model(model, target)
    K = len(betas)
    x = torch.cat([_slice3_start(m, C, seed=C + 9 + k) if target != "bimodal" else
                   torch.tensor(np.random.default_rng(C + k).normal(0.0, 4.0, (1, C)),
                                dtype=torch.float32, device="cuda") for k in range(K)])
    d = x.shape[0] // K
    ell = torch.cat([m.tile_density(x[k * d:(k + 1) * d], *m.tile_consts) for k in range(K)])
    args = (m.tile_density, m.cuda_density, x, ell, m.tile_consts, 100)
    kw = dict(betas=betas, scale=scale, replica_scales=rs, burn=burn, thin=thin, n_samples=n,
              iteration_offset=offset)
    before = fused_tempering_sample.launches
    got = fused_tempering_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_tempering_sample.launches == before + 1
    ref = tempering_sample_reference(*args, **kw)
    dec, chains = _agree(got, ref)
    assert dec >= 0.999 and chains >= 0.999
    ladder = _bits_or_close(got[3], ref[3]) & _bits_or_close(got[4], ref[4]) & \
        (got[5] == ref[5]).all(0)
    assert float(ladder.float().mean()) >= 0.999
    assert not bool(torch.isnan(got[3]).any() or torch.isnan(got[4]).any())


@pytest.mark.parametrize("target,M,snooker", [
    ("emcee", 1024, 0.0), ("emcee", 1000, 0.3), ("corr2", 512, 0.5), ("emcee", 6, 0.3),
])
@pytest.mark.parametrize("burn,thin,n,offset", [(0, 1, 32, 0), (4, 3, 9, (1 << 32) - 12)])
def test_demc_kernel_matches_plain(model, target, M, snooker, burn, thin, n, offset):
    """Members read each other, so one flipped decision spreads: the
    decisions over the run and the draws element-wise, as emcee's."""
    from advancedmh_tpu_torch.ops import DemcParams, demc_sample_reference, fused_demc_sample

    m = _slice7_model(model, target)
    rng = np.random.default_rng(M)
    x = (torch.tensor(np.stack([rng.uniform(-0.2, 4.0, M), rng.normal(1.0, 1.0, M)]),
                      dtype=torch.float32, device="cuda") if target == "emcee"
         else _gauss_start(2, M, M))
    args = (m.tile_density, m.cuda_density, x, m.tile_density(x, *m.tile_consts), m.tile_consts, 6)
    kw = dict(params=DemcParams(2.38 / np.sqrt(4.0), snooker_probability=snooker), burn=burn,
              thin=thin, n_samples=n, iteration_offset=offset)
    before = fused_demc_sample.launches
    got = fused_demc_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_demc_sample.launches == before + 1
    ref = demc_sample_reference(*args, **kw)
    assert float((got[2] == ref[2]).float().mean()) >= 0.999
    assert float(_close(got[0], ref[0]).float().mean()) >= 0.999


def test_slice7_wrappers_raise_for_what_has_no_kernel(model):
    """An unknown tag, a missing tag, or a (tag, d) the library lacks raises
    _build.check's ValueError for the four slice-7 kernels."""
    from advancedmh_tpu_torch.ops import (DemcParams, fused_demc_sample, fused_mtm,
                                          fused_mtm_sample, fused_tempering_sample)

    lp = lambda x: torch.zeros(1, x.shape[1], device="cuda")
    one = lambda x: torch.ones(x.shape[0], device="cuda")
    calls = {
        "mtm_sample": ("mtm", lambda tag, x: fused_mtm_sample(
            model.tile_density, tag, x, lp(x), one(x), model.tile_consts, 1, k=2, burn=0,
            thin=1, n_samples=2)),
        "mtm": ("mtm", lambda tag, x: fused_mtm(
            model.tile_density, tag, x, lp(x), one(x), model.tile_consts, 1, k=2, n_steps=2)),
        "tempering": ("tempering", lambda tag, x: fused_tempering_sample(
            model.tile_density, tag, torch.cat([x, x]), torch.zeros(2, x.shape[1], device="cuda"),
            model.tile_consts, 1, betas=(1.0, 0.5), scale=0.3, burn=0, thin=1, n_samples=2)),
        "demc": ("demc", lambda tag, x: fused_demc_sample(
            model.tile_density, tag, x, lp(x), model.tile_consts, 1, params=DemcParams(0.5),
            burn=0, thin=1, n_samples=2)),
    }
    p = torch.zeros(2, 64, device="cuda")
    for name, (source, call) in calls.items():
        with pytest.raises(ValueError, match="CUDA density tag"):
            call(None, p)
        with pytest.raises(ValueError, match="'banana'"):
            call("banana", p)
        with pytest.raises(ValueError, match="instantiates only"):
            call("correlated_gaussian", torch.zeros(3, 64, device="cuda"))
        have = ("emcee_demo", 2) if source == "demc" else ("correlated_gaussian", 2)
        assert have in _build.kernel_pairs(_build.library(), source)
    assert ("bimodal_mixture", 1) in _build.kernel_pairs(_build.library(), "tempering")


# ---- slice 8: the power-posterior (evidence) kernel ---------------------------------


def _evidence_inputs(target, C, seed):
    """A ladder batch: the likelihood model, x (d, C) from its prior, ll, the
    prior's lp, a β row over power_ladder(16) (a β = 0 chain beside ll = -inf
    among them) and the prior's columns."""
    from advancedmh_tpu_torch import power_ladder
    from advancedmh_tpu_torch.models import flat_likelihood, normal_mean_likelihood
    from advancedmh_tpu_torch.ops import gaussian_prior_lp

    if target == "conjugate":
        m, s = normal_mean_likelihood([0.8, 1.3, 0.2, 1.0, 0.6], 1.0, device="cuda"), 1.0
    elif target == "flat":
        m, s = flat_likelihood(2, device="cuda"), 1.0
    else:
        from advancedmh_tpu_torch.models import logistic_regression_model

        m = logistic_regression_model(256, 32, seed=0, prior_scale=float("inf"), device="cuda")
        s = 10.0
    d = m.dimension
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0.0, s, (d, C)), dtype=torch.float32, device="cuda")
    loc = torch.zeros(d, device="cuda")
    scale = torch.full((d,), s, device="cuda")
    ll = m.tile_density(x, *m.tile_consts)
    ll[0, 0] = -float("inf")
    beta = torch.tensor(rng.choice(power_ladder(16), C)[None], dtype=torch.float32,
                        device="cuda")
    beta[0, 0] = 0.0
    plp = gaussian_prior_lp(x, loc[:, None], scale[:, None], torch.log(scale)[:, None])
    return m, x, ll, plp, beta, loc, scale


@pytest.mark.parametrize("target", ["conjugate", "flat", "logreg"])
@pytest.mark.parametrize("adapt,per_rung", [(True, False), (False, True)])
@pytest.mark.parametrize("C,burn,thin,n,offset", [
    (4096, 32, 1, 32, 0), (4001, 10, 3, 11, (1 << 32) - 20),
])
def test_evidence_kernel_matches_plain(target, adapt, per_rung, C, burn, thin, n, offset):
    """The emitted log-likelihoods and accept flags and the frozen ε̄ against
    the plain version: at least 99.9% of decisions and chains agree (lp
    within 1e-5), the β = 0 chain beside ll = -inf never accepts."""
    from advancedmh_tpu_torch.ops import fused_power_rwmh_sample, power_rwmh_reference

    m, x, ll, plp, beta, loc, scale = _evidence_inputs(target, C, C)
    eps0 = (0.02 + 0.5 * torch.rand(1, C, generator=torch.Generator().manual_seed(C))).cuda() \
        if per_rung else torch.full((1, C), 0.5, device="cuda")
    args = (m.tile_density, m.cuda_density, x, ll, plp, beta, eps0, loc, scale, m.tile_consts,
            91)
    kw = dict(n_samples=n, burn=burn, thin=thin, adapt=adapt, iteration_offset=offset)
    before = fused_power_rwmh_sample.launches
    got = fused_power_rwmh_sample(*args, **kw)
    torch.cuda.synchronize()
    assert fused_power_rwmh_sample.launches == before + 1
    ref = power_rwmh_reference(*args, **kw)
    dec = (got[1] == ref[1]).reshape(-1, C)
    ok = dec.all(dim=0) & _close(got[0], ref[0]).all(dim=0)[0] & _close(got[2], ref[2])[0]
    assert float(dec.float().mean()) >= 0.999 and float(ok.float().mean()) >= 0.999
    assert torch.all(got[1][:, 0, 0] == 0) and torch.all(got[0][:, 0, 0] == -float("inf"))


def _evidence_steps(m, x, ll, plp, beta, eps, loc, scale, seed, offset, n):
    """The plain version's state (x, ll, plp) after n steps at a fixed ε."""
    from advancedmh_tpu_torch.ops.evidence import gaussian_prior_lp, power_step
    from advancedmh_tpu_torch.ops.common import step_noise

    lo, sc = loc[:, None], scale[:, None]
    prior = lambda y: gaussian_prior_lp(y, lo, sc, torch.log(sc))
    lik = lambda y: m.tile_density(y, *m.tile_consts)
    z, logu = step_noise(seed, offset + 1, n, x.shape[1], x.shape[0], x.device)
    for i in range(n):
        x, ll, plp, _ = power_step(x, ll, plp, beta, eps, z[i], logu[i][None], lik, prior)
    return x.contiguous(), ll.contiguous(), plp.contiguous()


@pytest.mark.parametrize("target,C", [("logreg", 8190), ("logreg", 100), ("conjugate", 4001),
                                      ("flat", 4001)])
@pytest.mark.parametrize("adapt", [True, False])
def test_evidence_group_kernel_is_bit_exact(target, C, adapt):
    """The evidence kernel on the logistic regression's 8 lanes a chain (its
    value alone, csrc/group.cuh) on chain counts that are not a multiple of
    its 16-chain blocks, and on the conjugate and flat likelihoods at one
    thread a chain; per-chain ε₀, burn 5, thin 3, offsets near 2**32: every
    output (log-likelihoods, decisions, ε̄) equal to the plain version's
    bits, the β = 0 chain beside ll = -inf never accepting, and without
    adaptation a run resumed from the plain steps' (x, ll, plp) equal to
    the whole run."""
    from advancedmh_tpu_torch.ops import fused_power_rwmh_sample, power_rwmh_reference

    m, x, ll, plp, beta, loc, scale = _evidence_inputs(target, C, C + 11)
    eps0 = torch.tensor(np.random.default_rng(C).uniform(0.02, 0.6, (1, C)),
                        dtype=torch.float32, device="cuda")
    seed, offset = 67, (1 << 32) - 9
    args = (m.tile_density, m.cuda_density, x, ll, plp, beta, eps0, loc, scale, m.tile_consts,
            seed)
    kw = dict(burn=5, thin=3, adapt=adapt)
    before = fused_power_rwmh_sample.launches
    got = fused_power_rwmh_sample(*args, n_samples=6, iteration_offset=offset, **kw)
    torch.cuda.synchronize()
    assert fused_power_rwmh_sample.launches == before + 1
    ref = power_rwmh_reference(*args, n_samples=6, iteration_offset=offset, **kw)
    for a, b in zip(got, ref):  # log-likelihoods, decisions, ε̄
        assert _same_bits(a, b)
    assert torch.all(got[1][:, 0, 0] == 0) and torch.all(got[0][:, 0, 0] == -float("inf"))
    if adapt:
        return
    first = fused_power_rwmh_sample(*args, n_samples=2, iteration_offset=offset, **kw)
    state = _evidence_steps(m, x, ll, plp, beta, eps0, loc, scale, seed, offset, 5 + 2 * 3)
    rest = fused_power_rwmh_sample(m.tile_density, m.cuda_density, *state, beta, eps0, loc,
                                   scale, m.tile_consts, seed, n_samples=4, burn=0, thin=3,
                                   adapt=False, iteration_offset=offset + 5 + 2 * 3)
    assert _same_bits(first[0][-1], state[1])
    for a, b, c in zip(got[:2], first[:2], rest[:2]):
        assert _same_bits(a, torch.cat([b, c]))
    assert _same_bits(got[2], rest[2])


def test_evidence_wrapper_raises_for_what_has_no_kernel():
    from advancedmh_tpu_torch.ops import fused_power_rwmh_sample

    m, x, ll, plp, beta, loc, scale = _evidence_inputs("flat", 64, 1)
    eps0 = torch.full((1, 64), 0.5, device="cuda")
    call = lambda tag, xx, lo, sc: fused_power_rwmh_sample(
        m.tile_density, tag, xx, ll, plp, beta, eps0, lo, sc, (), 1, n_samples=2, burn=1)
    with pytest.raises(ValueError, match="CUDA density tag"):
        call(None, x, loc, scale)
    with pytest.raises(ValueError, match="'banana'"):
        call("banana", x, loc, scale)
    z3 = torch.zeros(3, device="cuda")
    with pytest.raises(ValueError, match="instantiates only"):
        call("flat", torch.zeros(3, 64, device="cuda"), z3, z3 + 1.0)
    pairs = _build.kernel_pairs(_build.library(), "evidence")
    assert {("normal_mean", 1), ("flat", 2), ("logistic_regression", 32)} <= pairs


# ---- the lag-window autocovariance of summary()'s ESS (csrc/autocov.cu) -------------------


def _ar1_draws(n, p, c, phi, seed):
    """(n, p, c) float32 AR(1) draws on the card, laid out as Chains.values."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    e = torch.randn((n, p, c), generator=gen, device="cuda")
    x = torch.empty_like(e)
    x[0] = e[0]
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return x


@pytest.mark.parametrize("n, p, c", [(4000, 2, 16384), (7, 1, 3), (300, 3, 33), (1000, 1, 1),
                                     (257, 2, 95), (129, 2, 4096)])
def test_autocov_window_matches_plain(n, p, c):
    """The sums within 1e-5 of S_0 (the sums of later lags are small beside
    it, and each side rounds its products and partial sums differently);
    two launches give the same bits; the wrapper reads Chains.values'
    strided (N, C) view in place."""
    from advancedmh_tpu_torch.diagnostics.ess import LAG_WINDOW
    from advancedmh_tpu_torch.ops.autocov import autocov_window, autocov_window_reference

    values = _ar1_draws(n, p, c, 0.9, seed=n + c)
    for i in range(p):
        x = values[:, i, :]
        m = torch.mean(x, dim=0)
        before = autocov_window.launches
        got = autocov_window(x, m, LAG_WINDOW)
        again = autocov_window(x, m, LAG_WINDOW)
        torch.cuda.synchronize()
        assert autocov_window.launches == before + 2
        ref = autocov_window_reference(x, m, LAG_WINDOW)
        assert got.shape == ref.shape == (min(LAG_WINDOW, n),)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref[0])
        assert torch.equal(got, again)


def test_autocov_window_refuses_strided_chains():
    from advancedmh_tpu_torch.ops.autocov import autocov_window

    x = torch.zeros(64, 8, device="cuda").T.contiguous().T
    with pytest.raises(ValueError, match="contiguously"):
        autocov_window(x, torch.zeros(8, device="cuda"), 16)


@pytest.mark.parametrize("phi, n, c", [(0.5, 4000, 16384), (0.9, 1000, 64), (0.0, 100, 4)])
def test_ess_window_on_the_card_equals_the_fft(phi, n, c):
    from advancedmh_tpu_torch.diagnostics.ess import _ess_fft, _ess_window, ess

    x = _ar1_draws(n, 1, c, phi, seed=7)[:, 0, :]
    got, decided = _ess_window(x)
    want = _ess_fft(x)
    assert bool(decided)
    assert abs(float(got) / float(want) - 1.0) <= 1e-5
    assert float(ess(x)) == float(got)


def test_ess_window_on_the_card_keeps_the_nan_rule_and_falls_back():
    """Constant draws whose mean the card's reduction gives exactly take the
    floor by the NaN rule. Where it rounds the mean (1.5 over 1000 draws),
    the centred draws are a constant of a few ulp: no pair sum truncates,
    and ess() gives the FFT's bits."""
    from advancedmh_tpu_torch.diagnostics.ess import _ess_fft, _ess_window, ess

    flat = torch.full((1000, 4), 2.0, device="cuda")
    got, decided = _ess_window(flat)
    assert bool(decided) and float(got) == float(_ess_fft(flat)) == 4000 / 1e-6
    near = torch.full((1000, 4), 1.5, device="cuda")
    assert torch.equal(ess(near), _ess_fft(near))
    slow = _ar1_draws(4000, 1, 4, 0.995, seed=3)[:, 0, :]
    assert not bool(_ess_window(slow)[1])
    before = ess.fft_fallbacks
    assert torch.equal(ess(slow), _ess_fft(slow)) and ess.fft_fallbacks == before + 1
