#!/usr/bin/env python3
"""The benchmark of ``unidet3d_tpu_torch`` on one NVIDIA H100: one cell, one
run. From the root of a checkout:

    python3 benchmark/run.py --workload joint-train-staged --seed 7 --seconds 30 --trace 0

See ``benchmark/README.md``."""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# numpy's OpenBLAS single-threaded, before numpy loads: the batches are built
# on several Python threads at once, and a multi-threaded OpenBLAS called
# from several threads at once returns products that differ from call to
# call, so two builds of one batch from one seed would not agree.
os.environ["OPENBLAS_NUM_THREADS"] = "1"

from benchmark.harness import runner  # noqa: E402

if __name__ == "__main__":
    runner.setup_environment(ROOT)
    sys.exit(runner.main(sys.argv[1:], T_START))
