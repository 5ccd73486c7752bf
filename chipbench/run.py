#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; ``chipbench/README.md``
says how to add one. Without a CUDA card, or with fewer cards than the
cell asks for, the run fails and prints no result.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START))
