#!/usr/bin/env python3
"""Run one benchmark cell of lcasr_torch once, on the CUDA card(s) of this
machine, and print its result as the last line of standard output.

    python3 lcbench/run.py --workload flagship.decode_20min --seed 7 --seconds 30 --trace 0

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its per-layer
metrics from a profiler trace of the window.  Without a card it exits with
code 2 and prints no result.  See lcbench/harness/runner.py.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lcbench.harness import runner  # noqa: E402

if __name__ == "__main__":
    runner.cache_dirs()
    sys.exit(runner.main(t_start=T_START))
