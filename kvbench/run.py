"""Run one cell of the port's benchmark and print its result line.

    python3 kvbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``compared`` last); the numbers compared, each beside its
limit, are the last lines of standard error.  Without a CUDA device with
as many cards as the cell asks for, or without the program beside the
benchmark, it prints no result and exits with a code other than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = ROOT / "build" / "kvbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from kvbench.bench import forbidden_loaded, load_cell
    from kvbench.serve import ProgramMissing, import_program, run_cell

    try:
        import_program(ROOT)
        cell = load_cell(args.workload, ROOT)
    except (ProgramMissing, FileNotFoundError, KeyError) as e:
        print(f"kvbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"kvbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    def log(msg):
        print(f"kvbench: {msg}", file=sys.stderr, flush=True)

    out = run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   t_start=T_START, log=log)
    bad = forbidden_loaded()
    if bad:
        print(f"kvbench: modules of the JAX package or JAX are loaded: {bad}", file=sys.stderr)
        return 4
    print(f"correct = {out['correct']}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
