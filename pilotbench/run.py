"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 pilotbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Kernel and compiler caches live in
``.pilotbench_cache/`` there, so only the first run of a checkout builds.
Exits with a non-zero code, and prints no result, without enough CUDA
devices.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
CACHE = ROOT / ".pilotbench_cache"
os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
# the harness's modules are imported as ``pilotbench.*`` only: the
# script's own directory leaves the path, so that none of them shadows a
# module of the standard library
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from pilotbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
