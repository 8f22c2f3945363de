#!/usr/bin/env python3
"""The benchmark of ``advancedmh_tpu_torch`` on one NVIDIA GPU: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``portbench/harness.py`` for what a run does and prints. Build and
kernel caches stay inside the checkout, under ``.portbench_cache/``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
