"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (cfnerf_torch) and a CUDA
device; without enough devices it exits 3 and prints no result.  The last
line of standard output is the result (JSON); the numbers that decided
`correct` are the last lines of standard error.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark.harness import main

    sys.exit(main(t_start=T_START))
