"""The package boundary of advancedmh_tpu_torch: it imports no JAX, imports
without triton or nvcc, and builds nothing until a kernel is launched."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "advancedmh_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)


def _run(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_no_source_file_imports_jax():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            assert not any(n == "jax" or n.startswith(("jax.", "advancedmh_tpu."))
                           or n == "advancedmh_tpu" for n in names), (path, names)


def test_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import advancedmh_tpu_torch as p\n"
        "assert 'jax' not in {k for k, v in sys.modules.items() if v is not None}\n"
        "print(len(p.__all__))\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_imports_without_triton_or_nvcc():
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import advancedmh_tpu_torch, advancedmh_tpu_torch.ops, advancedmh_tpu_torch.convert\n"
        "from advancedmh_tpu_torch.ops import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
    )
    r = _run(code, env)
    assert r.returncode == 0, r.stderr


def test_fused_path_on_cpu_launches_nothing():
    import advancedmh_tpu_torch as port
    from advancedmh_tpu_torch.models import gaussian_mean_scale_model
    from advancedmh_tpu_torch.ops import _build, fused_rwmh, fused_rwmh_sample

    fused_rwmh_sample.launches = fused_rwmh.launches = 0
    c = port.sample(gaussian_mean_scale_model(device="cpu"), port.RWMH(port.MvNormal(torch.zeros(2), scale=0.3)),
                    20, num_chains=8, engine="fused", discard_initial=5,
                    initial_params=[0.0, 1.0], chain_type="chains")
    assert c.values.shape == (20, 2, 8)
    assert fused_rwmh_sample.launches == 0 and fused_rwmh.launches == 0
    assert _build.library.cache_info().currsize == 0


def test_kernel_sources_ship_with_the_package():
    from advancedmh_tpu_torch.ops import _build

    for name in ("philox.cuh", "common.cuh", *(f"{k}.cu" for k in _build.KERNELS)):
        assert (PKG / "csrc" / name).is_file(), name
    text = (ROOT / "pyproject.toml").read_text()
    assert '"csrc/*.cu"' in text and '"csrc/*.cuh"' in text


def test_every_wrapper_on_cpu_launches_nothing():
    """The kernel wrappers: the main paths on CPU tensors run the plain
    versions, and no library is built or loaded."""
    import numpy as np

    import advancedmh_tpu_torch as port
    from advancedmh_tpu_torch.models import (correlated_gaussian_model, emcee_demo_model,
                                             gaussian_mean_scale_model, gp_latent_model)
    from advancedmh_tpu_torch.ops import KERNEL_WRAPPERS, _build

    for w in KERNEL_WRAPPERS.values():
        w.launches = 0
    flag = gaussian_mean_scale_model(device="cpu")
    kw = dict(num_chains=8, initial_params=[0.0, 1.0])
    port.sample(flag, port.MALA.langevin(0.02), 5, engine="fused", discard_initial=2, **kw)
    port.sample(flag, port.RobustAdaptiveMetropolis(), 5, engine="fused", num_warmup=3, **kw)
    port.sample(correlated_gaussian_model(np.eye(2), device="cpu"),
                port.RobustAdaptiveMetropolis(pooled=True), 5, engine="fused", num_warmup=3,
                num_chains=8, initial_params=[0.0, 0.0])
    port.sample(emcee_demo_model(device="cpu"),
                port.Ensemble(16, port.StretchProposal([port.InverseGamma(2.0, 3.0),
                                                        port.Normal(0.0, 1.0)])),
                5, engine="fused")
    port.sample(flag, port.SliceSampler(), 5, engine="fused", discard_initial=2, **kw)
    port.sample(flag, port.Barker(0.1), 5, engine="fused", discard_initial=2, **kw)
    gp, prior, _ = gp_latent_model(8, device="cpu")
    for spl in (port.EllipticalSlice(prior), port.PreconditionedCrankNicolson(prior)):
        port.sample(gp, spl, 5, engine="fused", num_chains=8)
    for spl in (port.AdaptiveMetropolis(), port.DRAM()):
        port.sample(correlated_gaussian_model(np.eye(2), device="cpu"), spl, 5, engine="fused",
                    discard_initial=2, num_chains=8, initial_params=[0.0, 0.0])
    rw = lambda s: port.RandomWalkProposal(port.MvNormal(torch.zeros(2), scale=s), symmetric=True)
    port.sample(flag, port.DelayedRejection(rw(0.5), rw(0.1)), 5, engine="fused",
                discard_initial=2, **kw)
    from advancedmh_tpu_torch.models import normal_mean_likelihood

    port.log_evidence(normal_mean_likelihood([0.5, 1.0], 1.0, device="cpu"),
                      port.MvNormal(torch.zeros(1)), 5, key=0, num_chains=4, engine="fused")
    assert all(w.launches == 0 for w in KERNEL_WRAPPERS.values())
    assert _build.library.cache_info().currsize == 0


class _FakeLibrary:
    """What _build.check reads from the library: its exported pairs and
    its error strings."""

    def __getattr__(self, name):
        if name.startswith("amh_pairs_"):
            return lambda: b"gaussian_mean_scale:2 correlated_gaussian:4 "
        raise AttributeError(name)

    @staticmethod
    def amh_error_string(code):
        return b"an error"


@pytest.mark.parametrize("kernel", ["rwmh", "mala", "ram", "emcee", "slice", "ess", "barker",
                                    "pcn", "am", "dr", "dram", "evidence"])
def test_check_is_the_one_error_for_missing_pairs(kernel):
    """No kernel for the (tag, d) pair -- an unknown tag, no tag, or a d the
    library lacks -- is one ValueError naming the pairs the library has; any
    other launch error is a RuntimeError."""
    from advancedmh_tpu_torch.ops import _build

    lib = _FakeLibrary()
    assert _build.kernel_pairs(lib, kernel) == {("gaussian_mean_scale", 2),
                                                ("correlated_gaussian", 4)}
    with pytest.raises(ValueError, match="'rosenbrock'.*instantiates only"):
        _build.check(lib, _build.NO_KERNEL, kernel, "rosenbrock", 2)
    with pytest.raises(ValueError, match="CUDA density tag"):
        _build.check(lib, _build.NO_KERNEL, kernel, None, 2)
    with pytest.raises(ValueError, match="d=3"):
        _build.check(lib, _build.NO_KERNEL, kernel, "gaussian_mean_scale", 3)
    with pytest.raises(RuntimeError, match="an error"):
        _build.check(lib, 700, kernel, "gaussian_mean_scale", 2)
    _build.check(lib, 0, kernel, "gaussian_mean_scale", 2)


def test_model_tags_name_cuda_functors():
    """Each model's cuda_density names a functor of csrc/common.cuh, and the
    C sources, not Python, list which kernels instantiate it."""
    import re

    import numpy as np

    from advancedmh_tpu_torch.models import (banana_model, bimodal_mixture_model,
                                             correlated_gaussian_model, emcee_demo_model,
                                             flat_likelihood, gaussian_mean_scale_model,
                                             gp_latent_model, logistic_regression_model,
                                             neal_funnel_model, normal_mean_likelihood)

    names = set(re.findall(r'kName = "(\w+)"', (PKG / "csrc" / "common.cuh").read_text()))
    tags = {m.cuda_density for m in (gaussian_mean_scale_model(device="cpu"),
                                     correlated_gaussian_model(np.eye(2), device="cpu"),
                                     emcee_demo_model(device="cpu"),
                                     logistic_regression_model(16, 2, device="cpu"),
                                     neal_funnel_model(device="cpu"),
                                     gp_latent_model(8, device="cpu")[0],
                                     gp_latent_model(8, "logistic", device="cpu")[0],
                                     banana_model(device="cpu"),
                                     bimodal_mixture_model(device="cpu"),
                                     normal_mean_likelihood([0.5], 1.0, device="cpu"),
                                     flat_likelihood(2, device="cpu"))}
    assert tags == names
    for path in PKG.rglob("*.py"):
        assert "CUDA_DENSITIES" not in path.read_text(), path
