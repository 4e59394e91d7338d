#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from: one cell run
on many seeds in one process (the program, its control, or a planted
fault), each run's compared numbers printed as one JSON line.

    python3 bench_port/checks/readings.py --workload cfg1_mc4_b2 \
        --seeds 101 102 103 --seconds 3 [--variant control] [--out FILE]

The runs use the cell's own sizes and its own check; ``--seconds`` only
shortens the window (each run still compares the cell's sample). The
limits of the workload file do not matter here: the numbers do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--variant", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_port import run

    for k, v in {**run.CACHE_DIRS, **run.THREADS}.items():
        os.environ[k] = v
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t = time.perf_counter()
            r = run.run_cell(args.workload, seed, args.seconds, False, variant=args.variant,
                             t_start=t)
            line = {"workload": args.workload, "variant": args.variant, "seed": seed,
                    "attempted": r["attempted"], "failed": r["failed"],
                    "checks": r["checks"], "correct": r["correct"],
                    "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                    "run_s": time.perf_counter() - t}
            text = json.dumps(run.strict(line), allow_nan=False)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
