"""The benchmark's command (`BENCHMARK.json`):

    python3 dasbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout; it puts the checkout and its `src/` on
the path itself.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

from dasbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
