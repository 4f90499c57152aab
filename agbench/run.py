"""Run one benchmark cell once and print its result as the last line.

    python3 agbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The cell is an entry of BENCHMARK.json's
"workloads"; agbench/harness.py says how it is run and what is printed.
Without a CUDA device, or with fewer cards than the cell asks for, it
exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from agbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
