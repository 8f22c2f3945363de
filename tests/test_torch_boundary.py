"""The package boundary of advancedmh_tpu_torch: it imports no JAX, imports
without triton or nvcc, and builds nothing until a kernel is launched."""
import ast
import os
import subprocess
import sys
from pathlib import Path

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
    c = port.sample(gaussian_mean_scale_model(), port.RWMH(port.MvNormal(torch.zeros(2), scale=0.3)),
                    20, num_chains=8, engine="fused", discard_initial=5,
                    initial_params=[0.0, 1.0], chain_type="chains")
    assert c.values.shape == (20, 2, 8)
    assert fused_rwmh_sample.launches == 0 and fused_rwmh.launches == 0
    assert _build.library.cache_info().currsize == 0


def test_kernel_sources_ship_with_the_package():
    assert (PKG / "csrc" / "rwmh.cu").is_file() and (PKG / "csrc" / "philox.cuh").is_file()
    text = (ROOT / "pyproject.toml").read_text()
    assert '"csrc/*.cu"' in text and '"csrc/*.cuh"' in text
