"""Run one cell of the benchmark once and print its result line:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout (see ``harness.py`` and ``README.md``)."""

import time

T_IMPORT = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ROOT,
                          harness.process_start() or T_IMPORT))
