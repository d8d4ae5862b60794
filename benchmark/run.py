"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:1] = [BENCH, os.path.dirname(BENCH)]

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(sys.argv[1:], T_START))
