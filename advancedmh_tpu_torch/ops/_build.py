"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

At first use ``nvcc`` compiles ``csrc/rwmh.cu`` for ``sm_90a`` into a shared
library with a plain C interface, in ``advancedmh_tpu_torch/_build/``. The
file name carries a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is. Nothing here runs when the
package is imported.

Flags: no ``--use_fast_math`` (approximate logf / sincosf flip accept
decisions against the plain version) and ``--fmad=false`` (each multiply and
add rounds as PyTorch's separate operations do, so the proposal's states
match the plain version's bit for bit). On an H100 (700 W) the flag cost the
sampling kernel nothing measurable at 16384 chains x 4499 steps (3.88 ms
with it, 3.93 ms without) and the throughput kernel 5% at 16384 x 10000
(7.31 against 6.96 ms), and it cut the decisions that differ from the plain
version's from 8.9e-7 to 2.6e-7 per chain-step. ``-Xptxas -v`` makes the
compiler report registers, shared memory and spills for each kernel;
:func:`build` returns that report.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("rwmh.cu", "philox.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

NO_KERNEL = -1  # amh::kNoKernel: no kernel instantiated for (density, d)

_P = ctypes.c_void_p
_I32, _I64, _U64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    # density, d, tril, params_t, lp, scale, consts, n_consts, seed, burn,
    # thin, n_samples, offset, C, samples, lps, accs, stream
    "amh_rwmh_sample": [_I32, _I32, _I32, _P, _P, _P, _P, _I32, _U64, _I64,
                        _I64, _I64, _U64, _I64, _P, _P, _P, _P],
    # density, d, tril, params_t, lp, scale, consts, n_consts, seed, n_steps,
    # offset, C, out_params, out_lp, out_acc, stream
    "amh_rwmh": [_I32, _I32, _I32, _P, _P, _P, _P, _I32, _U64, _I64, _U64,
                 _I64, _P, _P, _P, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libamh_rwmh_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns (library path, seconds spent compiling, compiler report)."""
    out = library_path()
    if out.is_file():
        return out, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / "rwmh.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int32
    lib.amh_error_string.argtypes = [ctypes.c_int32]
    lib.amh_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str, density: str, d: int) -> None:
    """Raise if a launch returned a nonzero error code: ValueError when the
    library has no kernel for the (density, d) pair, else RuntimeError."""
    if code == NO_KERNEL:
        raise ValueError(
            f"CUDA density {density!r} has no {what} kernel instantiated for "
            f"d={d} in csrc/rwmh.cu"
        )
    if code != 0:
        msg = lib.amh_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed (code {code}): {msg}")
