"""The port's benchmark: one run of one cell.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object) and each number compared with its limit as the last lines of
standard error. Exits non-zero, printing no result, where there is no CUDA
card or fewer than the cell asks for. See harness.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402

if __name__ == '__main__':
    sys.exit(harness.main(t_start=T_START))
