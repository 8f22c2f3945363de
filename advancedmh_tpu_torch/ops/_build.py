"""Build and load the CUDA kernels of ``csrc/`` (nvcc + ctypes).

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into one shared
library with a plain C interface, in ``advancedmh_tpu_torch/_build/``. The
file name carries a hash of all sources and flags, so a changed source is
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
:func:`build` returns that report. ``--split-compile=0`` compiles the kernels
of one source in parallel threads: ``ess.cu`` and ``pcn.cu``, whose unrolled
64 × 64 triangular matvecs make them the slowest sources, took 84-211 s each
in five builds without it and 87-140 s in two with it on the H100 machine's
8 cores (the time varies with the machine's load).

Which (density, d) pairs each kernel is instantiated for is said once, in
its source's registry list; the library exports it (:func:`kernel_pairs`)
and an entry point returns ``NO_KERNEL`` for any other pair, which
:func:`check` turns into the one ``ValueError``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import FrozenSet, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# each csrc/<name>.cu exports amh_pairs_<name>
KERNELS = ("rwmh", "mala", "ram", "emcee", "adapt", "hmc", "hmc_adapt", "chees", "meads",
           "slice", "ess", "barker", "pcn", "am", "dr", "dram", "mtm", "tempering", "demc",
           "evidence")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v", "--split-compile=0",
)

NO_KERNEL = -1  # amh::kNoKernel: no kernel instantiated for (density, d)

_P = ctypes.c_void_p
_S = ctypes.c_char_p
_F = ctypes.c_float
_I32, _I64, _U64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    # density, d, tril, params_t, lp, scale, consts, n_consts, seed, burn,
    # thin, n_samples, offset, C, samples, lps, accs, stream
    "amh_rwmh_sample": [_S, _I32, _I32, _P, _P, _P, _P, _I32, _U64, _I64,
                        _I64, _I64, _U64, _I64, _P, _P, _P, _P],
    # density, d, tril, params_t, lp, scale, consts, n_consts, seed, n_steps,
    # offset, C, out_params, out_lp, out_acc, stream
    "amh_rwmh": [_S, _I32, _I32, _P, _P, _P, _P, _I32, _U64, _I64, _U64,
                 _I64, _P, _P, _P, _P],
    # density, d, params_t, lp, grad, consts, n_consts, sigma, half_s2,
    # inv_2s2, seed, burn, thin, n_samples, offset, C, samples, lps, accs,
    # out_grad, stream
    "amh_mala_sample": [_S, _I32, _P, _P, _P, _P, _I32, _F, _F, _F, _U64,
                        _I64, _I64, _I64, _U64, _I64, _P, _P, _P, _P, _P],
    # density, d, clamp, params_t, lp, S, consts, n_consts, alpha, gamma,
    # eig_lo, eig_hi, seed, warmup, thin, n_samples, offset, C, samples, lps,
    # accs, S_out, stream
    "amh_ram_sample": [_S, _I32, _I32, _P, _P, _P, _P, _I32, _F, _F, _F, _F,
                       _U64, _I64, _I64, _I64, _U64, _I64, _P, _P, _P, _P, _P],
    # density, d, x_state, lp_state, consts, n_consts, a, W, T, seed, burn,
    # thin, n_samples, offset, samples, lps, accs, stream
    "amh_emcee_sample": [_S, _I32, _P, _P, _P, _I32, _F, _I64, _I64, _U64,
                         _I64, _I64, _I64, _U64, _P, _P, _P, _P],
    # density, d, resume, params_t, lp, log_eps_bar, consts, n_consts, target,
    # t0, kappa, gamma, mu, log_eps0, seed, warmup, thin, n_samples, offset,
    # C, samples, lps, accs, log_eps_bar_out, stream
    "amh_adapt_rwmh_sample": [_S, _I32, _I32, _P, _P, _P, _P, _I32, _F, _F, _F,
                              _F, _F, _F, _U64, _I64, _I64, _I64, _U64, _I64,
                              _P, _P, _P, _P, _P],
    # density, d, params_t, lp, grad, minv, consts, n_consts, eps, n_leapfrog,
    # seed, burn, thin, n_samples, offset, C, samples, lps, accs, x_state,
    # g_state, stream
    "amh_hmc_sample": [_S, _I32, _P, _P, _P, _P, _P, _I32, _F, _I32, _U64,
                       _I64, _I64, _I64, _U64, _I64, _P, _P, _P, _P, _P, _P],
    # density, d, resume, params_t, lp, grad, log_eps_bar, minv, consts,
    # n_consts, target, t0, kappa, gamma, mu, log_eps0, mass_reg, warm_start,
    # n_leapfrog, seed, warmup, thin, n_samples, offset, C, samples, lps,
    # accs, log_eps_bar_out, minv_out, x_state, g_state, mean, m2, stream
    "amh_adaptive_hmc_sample": [_S, _I32, _I32, _P, _P, _P, _P, _P, _P, _I32,
                                _F, _F, _F, _F, _F, _F, _F, _F, _I32, _U64,
                                _I64, _I64, _I64, _U64, _I64, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P],
    # density, d, params_t, lp, grad, sv_in, minv_in, trips, us, E, n_groups,
    # consts, n_consts, target, t0, kappa, gamma, mu, lr, b1, 1 - b1, b2,
    # 1 - b2, log b1, log b2, log max_leapfrog, mass_reg, warm_start,
    # adapt_mass, seed, offset, C, tile, x_state, lp_out, g_state, acc_out,
    # sv_tiles, sum_x, sum_x2, partials, nb, stream
    "amh_chees_warmup": [_S, _I32, _P, _P, _P, _P, _P, _P, _P, _I32, _I64, _P, _I32,
                         *([_F] * 15), _I32, _U64, _U64, _I64, _I64, _P, _P, _P, _P,
                         _P, _P, _P, _P, _I64, _P],
    # density, d, params_t, lp, grad, eps, eps_per_chain, minv, consts,
    # n_consts, trips, P, phase, seed, thin, n_samples, offset, C, samples,
    # lps, accs, x_state, g_state, stream
    "amh_chees_frozen_sample": [_S, _I32, _P, _P, _P, _P, _I32, _P, _P, _I32, _P, _I32,
                                _I64, _U64, _I64, _I64, _U64, _I64, _P, _P, _P, _P, _P,
                                _P],
    # density, d, precond, nonrev, x, lp, g, p, u, consts, n_consts, mult,
    # clip, slowdown, K, tile, C, seed, t0, burn, thin, n_samples, samples,
    # lps, accs, partials, nb, stream
    "amh_meads_sample": [_S, _I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _I32, _F, _F, _F,
                         _I32, _I64, _I64, _U64, _U64, _I64, _I64, _I64, _P, _P, _P, _P,
                         _I64, _P],
    # density, d, params_t, lp, consts, n_consts, width, max_stepout,
    # max_shrink, seed, burn, thin, n_samples, offset, C, samples, lps, accs,
    # stream
    "amh_slice_sample": [_S, _I32, _P, _P, _P, _I32, _F, _I32, _I32, _U64, _I64, _I64,
                         _I64, _U64, _I64, _P, _P, _P, _P],
    # density, d, tril, params_t, lp, loc, scale, consts, n_consts, max_shrink,
    # seed, burn, thin, n_samples, offset, C, samples, lps, accs, stream
    "amh_ess_sample": [_S, _I32, _I32, _P, _P, _P, _P, _P, _I32, _I32, _U64, _I64, _I64,
                       _I64, _U64, _I64, _P, _P, _P, _P],
    # density, d, params_t, lp, grad, consts, n_consts, sigma, seed, burn, thin,
    # n_samples, offset, C, samples, lps, accs, out_grad, stream
    "amh_barker_sample": [_S, _I32, _P, _P, _P, _P, _I32, _F, _U64, _I64, _I64, _I64,
                          _U64, _I64, _P, _P, _P, _P, _P],
    # density, d, tril, params_t, lp, mean, scale, consts, n_consts, rho, beta,
    # seed, burn, thin, n_samples, offset, C, samples, lps, accs, stream
    "amh_pcn_sample": [_S, _I32, _I32, _P, _P, _P, _P, _P, _I32, _F, _F, _U64, _I64, _I64,
                       _I64, _U64, _I64, _P, _P, _P, _P],
    # density, d, x, lp, mean, L, n, consts, n_consts, beta, fs, os,
    # adapt_start, seed, burn, thin, n_samples, offset, C, samples, lps, accs,
    # mean_out, L_out, n_out, stream
    "amh_am_sample": [_S, _I32, _P, _P, _P, _P, _P, _P, _I32, _F, _F, _F, _F, _U64, _I64,
                      _I64, _I64, _U64, _I64, _P, _P, _P, _P, _P, _P, _P],
    # density, d, params_t, lp, s1, s2, consts, n_consts, seed, burn, thin,
    # n_samples, offset, C, samples, lps, accs, stream
    "amh_dr_sample": [_S, _I32, _P, _P, _P, _P, _P, _I32, _U64, _I64, _I64, _I64, _U64, _I64,
                      _P, _P, _P, _P],
    # density, d, x, lp, mean, L, n, consts, n_consts, os, gs, gm, seed, burn,
    # thin, n_samples, offset, C, samples, lps, accs, mean_out, L_out, n_out,
    # stream
    "amh_dram_sample": [_S, _I32, _P, _P, _P, _P, _P, _P, _I32, _F, _F, _F, _U64, _I64, _I64,
                        _I64, _U64, _I64, _P, _P, _P, _P, _P, _P, _P],
    # density, d, tril, params_t, lp, scale, consts, n_consts, k, seed, burn,
    # thin, n_samples, offset, C, samples, lps, accs, stream
    "amh_mtm_sample": [_S, _I32, _I32, _P, _P, _P, _P, _I32, _I32, _U64, _I64, _I64, _I64,
                       _U64, _I64, _P, _P, _P, _P],
    # density, d, tril, params_t, lp, scale, consts, n_consts, k, seed,
    # n_steps, offset, C, out_params, out_lp, out_acc, stream
    "amh_mtm": [_S, _I32, _I32, _P, _P, _P, _P, _I32, _I32, _U64, _I64, _U64, _I64, _P, _P,
                _P, _P],
    # density, d, x, ell, betas, dbetas, scales, consts, n_consts, K, seed,
    # burn, thin, n_samples, offset, C, samples, lps, accs, x_out, ell_out,
    # sw_out, stream
    "amh_tempering_sample": [_S, _I32, _P, _P, _P, _P, _P, _P, _I32, _I32, _U64, _I64, _I64,
                             _I64, _U64, _I64, _P, _P, _P, _P, _P, _P, _P],
    # density, d, x_state, lp_state, consts, n_consts, gamma, noise, p_jump,
    # p_snooker, snooker_gamma, (d-1)/2, M, seed, burn, thin, n_samples,
    # offset, samples, lps, accs, stream
    "amh_demc_sample": [_S, _I32, _P, _P, _P, _I32, _F, _F, _F, _F, _F, _F, _I64, _U64, _I64,
                        _I64, _I64, _U64, _P, _P, _P, _P],
    # density, d, adapt, x_t, ll, plp, beta, eps0, consts (then loc, scale),
    # n_consts, target, t0, kappa, gamma, seed, burn, thin, n_samples, offset,
    # C, lls, accs, eps_out, stream
    "amh_power_rwmh_sample": [_S, _I32, _I32, _P, _P, _P, _P, _P, _P, _I32, _F, _F, _F, _F,
                              _U64, _I64, _I64, _I64, _U64, _I64, _P, _P, _P, _P],
}

# An H100 block may use at most 227 KB of shared memory; the density's
# constants are copied there whole (csrc/common.cuh::allow_shared).
MAX_SHARED_BYTES = 232448


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"libamh_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, float, str]:
    """Compile the kernels unless the library for these sources exists.

    Returns (library path, seconds spent compiling, compiler report: each
    source's compile time, then nvcc's output for it)."""
    out = library_path()
    if out.is_file():
        return out, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]

    def compile_one(src, obj):
        t = time.perf_counter()
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return src.name, r.returncode, r.stdout, time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        results = list(pool.map(compile_one, srcs, objs))
    report, failed = [], []
    for name, code, text, seconds in results:
        report.append(f"amh build: {name} compiled in {seconds:.1f} s\n{text}")
        if code != 0:
            failed.append(f"{name} ({code}):\n{text}")
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_name(f"{tag}.so.tmp")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, time.perf_counter() - t0, "".join(report)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int32
    for name in KERNELS:
        getattr(lib, f"amh_pairs_{name}").restype = ctypes.c_char_p
    lib.amh_error_string.argtypes = [ctypes.c_int32]
    lib.amh_error_string.restype = ctypes.c_char_p
    return lib


def kernel_pairs(lib: ctypes.CDLL, kernel: str) -> FrozenSet[Tuple[str, int]]:
    """The (density tag, d) pairs the library instantiated ``kernel`` for
    (``kernel`` is a source name of :data:`KERNELS`)."""
    text = getattr(lib, f"amh_pairs_{kernel}")().decode()
    return frozenset((tag, int(d)) for tag, d in
                     (item.rsplit(":", 1) for item in text.split()))


def density_arg(cuda_density: Optional[str]) -> Optional[bytes]:
    """A model's ``cuda_density`` tag as the C entry points take it."""
    return None if cuda_density is None else cuda_density.encode()


def check_shared_memory(n_floats: int) -> None:
    """Raise before any launch when ``n_floats`` float32 constants exceed
    the shared memory one block can use."""
    if n_floats * 4 > MAX_SHARED_BYTES:
        raise ValueError(
            f"the density's constants take {n_floats * 4} bytes of shared memory; "
            f"a block on this card may use at most {MAX_SHARED_BYTES} bytes (227 KB)"
        )


def check(lib: ctypes.CDLL, code: int, kernel: str, density: Optional[str],
          d: int) -> None:
    """Raise if a launch returned a nonzero error code: ValueError when the
    library has no ``kernel`` instantiated for the (density, d) pair (an
    unknown or missing tag included), else RuntimeError."""
    if code == NO_KERNEL:
        have = ", ".join(f"{t}:{k}" for t, k in sorted(kernel_pairs(lib, kernel)))
        what = ("this model has no CUDA density tag (model.cuda_density)"
                if density is None else
                f"CUDA density {density!r} at d={d} has no {kernel} kernel")
        raise ValueError(
            f"{what}; csrc/{kernel}.cu instantiates only {have}"
        )
    if code != 0:
        msg = lib.amh_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed (code {code}): {msg}")
