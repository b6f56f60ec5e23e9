"""The readings that set a cell's correctness limit: for each seed, a run
of the cell at its own rate (a short window), the program's widest logit
gap and the float8 control's on the same sample.  One process, the kernels
built once.

    python3 kvbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 10

Prints one JSON line a seed and writes them to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rate", type=float, help="offer this rate instead of the cell's")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from kvbench.bench import load_cell
    from kvbench.run import _caches
    from kvbench.serve import import_program, run_cell

    _caches()
    import_program(ROOT)
    cell = load_cell(args.workload, ROOT)
    if args.rate:
        cell.cell = dict(cell.cell, rate=args.rate)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = run_cell(cell, seed=seed, seconds=args.seconds, trace=False, t_start=t,
                       control=True, log=lambda m: print(f"kvbench: {m}", file=sys.stderr,
                                                         flush=True))
        row = {"workload": args.workload, "seed": seed, "correct": out["correct"],
               "readings": out["readings"], "attempted": out["attempted"],
               "failed": out["failed"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        if args.out:
            pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
