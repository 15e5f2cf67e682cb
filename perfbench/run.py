"""Run one cell of the benchmark once:

    python3 perfbench/run.py --workload kfslam.loop24 --seed 1 --seconds 45 --trace 0

from the root of a checkout.  It needs a CUDA device and prints the
result as the last line of its standard output.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout
CACHE = os.path.join(ROOT, "build", "perfbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
# one process with few threads: host-side math runs on one core, a small
# fixed load on the run's host
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from perfbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
