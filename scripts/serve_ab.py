"""Compare the port's serving times between checkouts on one GPU.

    python3 scripts/serve_ab.py --arch yi-9b OLD NEW NEW OLD

Each ROOT is a checkout of this repo (its ``src/repro_torch`` is the
code under test); the roots run one after another, each in a process of
its own, so list them interleaved (old, new, new, old) to spread drift
of the card's clocks over both.  A process first serves one warm-up
request (its kernels built and loaded), then ``--reps`` times runs
``repro_torch.launch.serve`` as phase 3 of chip_smoke.py does (3
requests of 96 tokens, 8 new tokens each, b = 1 decode) and reads the
service's mean TTFT and TBT; then it times ``--steps`` decode steps of
the model itself at b = 1 after a 96-token prompt, on the host's clock
with the device synchronised every step.  One JSON line per root, then
the medians of each root's repetitions.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

METRIC = re.compile(r"request\.(tbt|ttft)_s: n=\d+ mean=([0-9.]+)")


def one_root(args) -> dict:
    """Run in a process whose ``sys.path`` starts at the root's ``src``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import build_model

    base = ["--arch", args.arch, "--prompt-len", "96", "--max-new", "8", "--device",
            args.device] + (["--smoke"] if args.smoke else [])
    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(base + ["--requests", "1"])
    reps = []
    for _ in range(args.reps):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve.main(base + ["--requests", "3"])
        got = dict((k, float(v)) for k, v in METRIC.findall(out.getvalue()))
        reps.append(got)
        gc.collect()  # the service's reference cycles hold the weights
        if args.device == "cuda":
            torch.cuda.empty_cache()

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init_params(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, 96).astype(np.int32)
    logits, state = model.prefill(params, {"tokens": torch.as_tensor(tokens[None])})
    tok = torch.argmax(logits[:, :cfg.vocab_size].float(), dim=-1).to(torch.int32)
    step_s = []
    for _ in range(args.steps):
        sync()
        t0 = time.perf_counter()
        logits, state = model.decode_step(params, state, tok)
        sync()
        step_s.append(time.perf_counter() - t0)
    return {"tbt_s": [r["tbt"] for r in reps], "ttft_s": [r["ttft"] for r in reps],
            "decode_step_s": statistics.median(step_s[1:])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+", type=pathlib.Path)
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda", help="cpu, with --smoke, for a dry run")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_root(args)))
        return 0
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    results = []
    for root in args.roots:
        root = root.resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        cmd = [sys.executable, str(pathlib.Path(__file__).resolve()), str(root), "--one",
               "--arch", args.arch, "--reps", str(args.reps), "--steps", str(args.steps),
               "--device", args.device] + (["--smoke"] if args.smoke else [])
        done = subprocess.run(cmd, env=env, cwd=root, capture_output=True, text=True)
        if done.returncode != 0:
            sys.stderr.write(done.stderr[-4000:])
            return done.returncode
        row = {"root": str(root), **json.loads(done.stdout.strip().splitlines()[-1])}
        print(json.dumps(row), flush=True)
        results.append(row)
    by_root: dict[str, list] = {}
    for row in results:
        by_root.setdefault(row["root"], []).append(row)
    for root, rows in by_root.items():
        tbt = [x for r in rows for x in r["tbt_s"]]
        ttft = [x for r in rows for x in r["ttft_s"]]
        step = [r["decode_step_s"] for r in rows]
        print(f"{root}: median of {len(tbt)} mean TBT {statistics.median(tbt):.6f} s, "
              f"of {len(ttft)} mean TTFT {statistics.median(ttft):.6f} s; decode step at "
              f"b = 1 {[f'{x:.6f}' for x in step]} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
