#!/usr/bin/env python3
"""Run one benchmark cell once with a fault of `lcbench/harness/model_faults.py`
planted under the timed path, to read how far a wrong program lies from the
cell's limits; never part of a benchmark run.  The other options are
`run.py`'s:

    python3 lcbench/plant.py --fault position_term_dropped --workload parakeet.decode_20min --seed 7 --seconds 51
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lcbench.harness import model_faults, runner  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", required=True, choices=model_faults.FAULTS)
    args, rest = ap.parse_known_args()
    runner.cache_dirs()
    with model_faults.planted(args.fault):
        sys.exit(runner.main(rest, t_start=T_START))
