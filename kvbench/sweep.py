"""The knee search of a cell: the highest offered rate at which the backlog
does not grow over the window and 90% of the requests due inside it meet
both latency limits.  One process, one set-up (kernels, weights), a fresh
service at each rate.

    python3 kvbench/sweep.py --workload <name> --seed <n> --seconds 60 --rates 0.2,0.3,0.5 \
        [--unloaded 6] [--out <file>]

The limits come from the same process: the unloaded time to first token
and time per output token (one request at a time, medians), times
``TTFT_FACTOR`` and ``TPOT_FACTOR``.  A request meets them when its first
token came within the TTFT limit of its due time and its mean gap between
tokens (DistServe's time per output token) is within the TPOT limit; a
request failed or unanswered misses.  Prints one JSON line a rate of the
ladder and the knee: the highest rate that held.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

TTFT_FACTOR = 5.0   # a first token may wait behind about four prefills
TPOT_FACTOR = 3.0   # every token is felt: a tighter multiple of the unloaded step
ATTAIN = 0.90
SWEEP_DRAIN_S = 30.0


def _tpot(times):
    return (times[-1] - times[0]) / (len(times) - 1) if len(times) > 1 else None


def unloaded(prog, cell, seed: int, n: int = 6) -> dict:
    """``n`` requests of the mix one at a time through a fresh service."""
    from kvbench import traffic
    from kvbench.serve import CLOCK

    svc = prog.service()
    arr = traffic.schedule(cell.traffic, rate=1.0, segments=(n,), seed=seed,
                           vocab=prog.m["vocab_size"])
    ttft, tpot = [], []
    for a in arr:
        t = CLOCK()
        h = svc.submit(a.prompt, max_new=a.output_len - 1, dispatch="queued")
        svc.loop.run_until_idle()
        ttft.append(h.metrics.token_times[0] - t)
        tpot.append(_tpot(h.metrics.token_times))
    del svc
    return {"ttft_s": statistics.median(ttft), "tpot_s": statistics.median(tpot)}


def at_rate(prog, cell, rate: float, seed: int, seconds: float, limits: dict) -> dict:
    from kvbench import traffic
    from kvbench.records import percentile
    from kvbench.serve import CLOCK, drive

    svc = prog.service()
    lead = float(cell.cell["lead_s"])
    arr = traffic.schedule(cell.traffic, rate=rate, seed=seed, vocab=prog.m["vocab_size"],
                           segments=(lead, seconds, SWEEP_DRAIN_S))
    t0 = CLOCK()
    w0, w1 = t0 + lead, t0 + lead + seconds
    subs, end = drive(svc, arr, t0=t0, w0=w0, w1=w1, need_last=True,
                      drain_max_s=SWEEP_DRAIN_S)
    prog.sync()
    due = [(a, h, d) for a, h, d in subs if w0 <= d < w1]

    def backlog(t):  # due by t and without a first token at t
        return sum(1 for _, h, d in subs if d <= t and not (
            h.metrics.token_times and h.metrics.token_times[0] <= t))
    met, ttft, gaps, tpots, late = 0, [], [], [], []
    for a, h, d in due:
        tt = h.metrics.token_times
        ok = bool(tt) and h.error is None
        ttft.append(tt[0] - d if tt else end - d)
        tp = _tpot(tt)
        if tp is not None:
            tpots.append(tp)
        ok = ok and ttft[-1] <= limits["ttft_s"] and (tp is None or tp <= limits["tpot_s"])
        met += ok
        late.append(h.metrics.submitted_at - d)
    for _, h, _ in subs:
        tt = h.metrics.token_times
        gaps += [b - a for a, b in zip(tt, tt[1:]) if w0 <= b < w1]
    toks = sum(1 for _, h, _ in subs for t in h.metrics.token_times if w0 <= t < w1)
    b0, b1 = backlog(w0), backlog(w1)
    del svc, subs, due
    row = {"rate": rate, "due": len(ttft), "attainment": met / max(1, len(ttft)),
           "backlog_w0": b0, "backlog_w1": b1,
           "ttft_p50_s": percentile(ttft, 50), "ttft_p95_s": percentile(ttft, 95),
           "tbt_p50_s": percentile(gaps, 50) if gaps else None,
           "tbt_p95_s": percentile(gaps, 95) if gaps else None,
           "tpot_p50_s": percentile(tpots, 50) if tpots else None,
           "late_p95_s": percentile(late, 95), "late_max_s": max(late),
           "tokens_per_s": toks / seconds}
    row["holds"] = (row["attainment"] >= ATTAIN
                    and b1 <= b0 + max(2, 0.05 * len(ttft)))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True, help="the ladder, comma-separated")
    ap.add_argument("--unloaded", type=int, default=6,
                    help="requests served one at a time for the unloaded times")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from kvbench.bench import load_cell
    from kvbench.run import _caches
    from kvbench.serve import Program, import_program

    _caches()
    import_program(ROOT)
    import torch

    cell = load_cell(args.workload, ROOT)
    prog = Program.build(cell, seed=args.seed, device="cuda")
    from repro_torch.kernels import build

    build.library()
    prog.warm_up(prog.service(), args.seed)
    base = unloaded(prog, cell, args.seed, args.unloaded)
    limits = {"ttft_s": TTFT_FACTOR * base["ttft_s"], "tpot_s": TPOT_FACTOR * base["tpot_s"]}
    head = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
            "unloaded": base, "limits": limits,
            "factors": {"ttft": TTFT_FACTOR, "tpot": TPOT_FACTOR}, "attainment": ATTAIN,
            "seconds": args.seconds, "date": time.strftime("%Y-%m-%d")}
    print(json.dumps(head), flush=True)
    rows = []
    for rate in (float(x) for x in args.rates.split(",")):
        rows.append(at_rate(prog, cell, rate, args.seed, args.seconds, limits))
        print(json.dumps(rows[-1]), flush=True)
    held = [row["rate"] for row in rows if row["holds"]]
    knee = {"knee": max(held) if held else None}
    print(json.dumps(knee), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({**head, "rows": rows, **knee}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
