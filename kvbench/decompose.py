"""Where a traced run's time goes, from the spans the program records inside
a decode step, a KV handoff and a prefill, and how far the harness's
device-trace mapping lies from the tracer's wall-clock anchor.

    python3 kvbench/decompose.py --workload <name> --seed <n> --seconds <s>

runs the cell as ``kvbench/run.py --trace 1`` does and prints its result
line, then one JSON object, last, with the decomposition:

* ``step``: the decode steps that ended in the window (``steps``,
  ``step_ms``, mean ``batch``), each ``step.*`` part in ms a step and their
  sum's share of the step; the rebuilds (how many, ms, ``bytes``,
  ``batch``, ``per_seq``) and the step's pumps (``txns`` a pump, requests
  ``promoted``).
* ``handoff``: over the requests due in the window that reached
  ``transfer``, the mean ``queue.kv`` wait, ``pull`` span and the rest of
  the ``transfer`` phase (promotion), in ms; a pull's ``txns``, ``pumps``
  (mean, least, most), ``bytes``, the steps a pull spans, the torn pulls,
  and the share of pulls inside their ``transfer`` phase.
* ``prefill``: the ``prefill`` phases of the same requests, in ms a
  thousand prompt tokens, each ``prefill.*`` part's share of them, and the
  digests' ``bytes`` a request.
* ``spans_per_s``: spans that started in the window a second, all and the
  inner ones (``step.*``, ``prefill.*``, ``pull``).
* ``clock``: ``delta_ms``, the harness's mapping of a device event minus
  the anchor's (``Tracer.anchor_at``), the anchor's bracket, and where
  kineto's trace start lies inside the wall-clock bracket of the slice's
  ``start()`` (which synchronises the device, then starts the profiler):
  inside it when kineto stamps on ``time.time_ns()``'s clock.
* ``gc``: the garbage collector's collections in the window, by
  generation, and their pauses.

A parent whose program records none of the inner spans reads only what it
has (its steps, its phases); nothing raises.
"""
from __future__ import annotations

import contextlib
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

INNER = ("step.pump", "step.rebuild", "step.launch", "step.sync", "prefill.forward",
         "prefill.park", "prefill.digest", "prefill.quant", "pull")


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def _ms(spans) -> float:
    return 1e3 * sum(s.t1 - s.t0 for s in spans)


def _steps(run) -> dict | None:
    from kvbench.spans import STEP_PARTS, step_part_ms, window_steps, within

    steps = window_steps(run)
    if not steps:
        return None
    mine = within([s for s in run.spans if s.name in STEP_PARTS and s.t1 is not None], steps)
    named = {p: [s for s in mine if s.name == p] for p in STEP_PARTS}
    out = {"steps": len(steps), "step_ms": _ms(steps) / len(steps),
           "batch": _mean(s.attrs.get("batch", 0) for s in named["step.launch"])}
    parts = {p: step_part_ms(run, p) for p in STEP_PARTS}
    if mine:
        out.update({f"{p}_ms": v for p, v in parts.items()})
        out["parts_share"] = sum(parts.values()) / out["step_ms"]
        rb, pm = named["step.rebuild"], named["step.pump"]
        out["rebuild"] = {"n": len(rb), "ms": _mean(1e3 * (s.t1 - s.t0) for s in rb),
                          **{k: _mean(s.attrs.get(k, 0) for s in rb)
                             for k in ("bytes", "batch", "per_seq")}}
        out["pump"] = {"n": len(pm), "txns": _mean(s.attrs.get("txns", 0) for s in pm),
                       "promoted": sum(s.attrs.get("promoted", 0) for s in pm)}
    return out


def _handoff(run, step_ms) -> dict | None:
    from kvbench.spans import request_spans

    lc, pulls = run.lifecycle(), request_spans(run, "pull")
    rows = []
    for r in run.due_in_window():
        ph = lc.get(r.rid, {})
        if "transfer" in ph:
            rows.append((ph.get("queue.kv", []), ph["transfer"], pulls.get(r.rid, [])))
    if not rows:
        return None
    out = {"requests": len(rows),
           "handoff_ms": _mean(_ms(q) + _ms(t) for q, t, _ in rows),
           "queue_kv_ms": _mean(_ms(q) for q, _, _ in rows)}
    pulled = [(t, p) for _, t, p in rows if p]
    if pulled:
        each = [s for _, p in pulled for s in p]
        pumps = [sum(s.attrs.get("pumps", 0) for s in p) for _, p in pulled]
        pull_ms = _mean(_ms(p) for _, p in pulled)
        out.update(
            pull_ms=pull_ms, promote_ms=_mean(_ms(t) - _ms(p) for t, p in pulled),
            txns=_mean(sum(s.attrs.get("txns", 0) for s in p) for _, p in pulled),
            pumps=_mean(pumps), pumps_least=min(pumps), pumps_most=max(pumps),
            bytes=_mean(sum(s.attrs.get("bytes", 0) for s in p) for _, p in pulled),
            steps_a_pull=pull_ms / step_ms if step_ms else None,
            torn=sum(bool(s.attrs.get("torn")) for s in each),
            inside_transfer=_mean(
                any(a.t0 <= s.t0 and s.t1 <= a.t1 for a in t) for t, p in pulled for s in p))
    return out


def _prefill(run) -> dict | None:
    from kvbench.spans import request_spans

    lc = run.lifecycle()
    rows = [(r, lc[r.rid]["prefill"]) for r in run.due_in_window()
            if "prefill" in lc.get(r.rid, {})]
    if not rows:
        return None
    total = sum(_ms(ph) for _, ph in rows)
    ktok = sum(r.prompt_len for r, _ in rows) / 1e3
    out = {"requests": len(rows), "prefill_ms_per_ktok": total / ktok}
    parts = {n: request_spans(run, n) for n in INNER if n.startswith("prefill.")}
    if any(parts.values()):
        for n, by_rid in parts.items():
            out[f"{n}_share"] = sum(_ms(by_rid.get(r.rid, [])) for r, _ in rows) / total
        out["covered"] = sum(out[f"{n}_share"] for n in parts)
        out["digest_bytes"] = _mean(sum(s.attrs.get("bytes", 0) for s in
                                        parts["prefill.digest"].get(r.rid, [])) for r, _ in rows)
    return out


def _clock(got: dict) -> dict | None:
    if got.get("anchor") is None or got.get("trace_start_ns") is None:
        return None
    t, wall_ns, err_ns = got["anchor"]
    return {"delta_ms": 1e3 * ((got["slice_t0"] - t) - (got["trace_start_ns"] - wall_ns) * 1e-9),
            "anchor_err_ns": err_ns,
            "kineto_start_in_start_us": (got["trace_start_ns"] - got["wall_before_start_ns"]) / 1e3,
            "start_us": (got["wall_after_start_ns"] - got["wall_before_start_ns"]) / 1e3}


def _gc(run, got: dict) -> dict | None:
    if "gc" not in got:
        return None
    done = [(g, a, b) for g, a, b in got["gc"] if run.in_window(a)]
    return {"collections": [sum(g == k for g, _, _ in done) for k in range(3)],
            "pause_ms": 1e3 * sum(b - a for _, a, b in done),
            "gen2_pause_ms": 1e3 * sum(b - a for g, a, b in done if g == 2)}


def decompose(run, got: dict | None = None) -> dict:
    """The decomposition of ``run``; ``got`` is what ``capture`` recorded
    beside it (the anchor, the slice's clocks, the collections)."""
    got = got or {}
    steps = _steps(run)
    started = [s for s in run.spans or () if run.in_window(s.t0)]
    return {"step": steps,
            "handoff": _handoff(run, steps["step_ms"] if steps else None),
            "prefill": _prefill(run),
            "spans_per_s": {"all": len(started) / run.window_s,
                            "inner": sum(s.name in INNER for s in started) / run.window_s},
            "clock": _clock(got), "gc": _gc(run, got)}


@contextlib.contextmanager
def capture():
    """Around ``kvbench.serve.run_cell``: keep its ``Run``, the tracer's
    anchor, the profiled slice's clocks and the collections' times."""
    from kvbench import profiling, serve
    from repro_torch.obs import trace

    got: dict = {"gc": []}
    Run, start, result = serve.Run, profiling.Slice.start, profiling.Slice.result
    anchor = getattr(trace.Tracer, "anchor", None)  # a tracer without one reads no clock

    def make_run(*a, **k):
        got["run"] = Run(*a, **k)
        return got["run"]

    def take_anchor(self):
        got["anchor"] = anchor(self)
        return got["anchor"]

    def start_slice(self):
        got["wall_before_start_ns"] = time.time_ns()
        start(self)
        got["wall_after_start_ns"] = time.time_ns()

    def slice_result(self):
        out = result(self)
        got["slice_t0"] = self.t0
        res = self.prof.profiler.kineto_results
        got["trace_start_ns"] = (res.trace_start_ns() if hasattr(res, "trace_start_ns")
                                 else 1000 * res.trace_start_us())
        return out

    open_gc: list = []

    def on_gc(phase, info):
        if phase == "start":
            open_gc.append(time.perf_counter())
        elif open_gc:
            got["gc"].append((info["generation"], open_gc.pop(), time.perf_counter()))

    saved = [(serve, "Run", Run, make_run), (profiling.Slice, "start", start, start_slice),
             (profiling.Slice, "result", result, slice_result)]
    if anchor is not None:
        saved.append((trace.Tracer, "anchor", anchor, take_anchor))
    for obj, name, _, new in saved:
        setattr(obj, name, new)
    gc.callbacks.append(on_gc)
    try:
        yield got
    finally:
        gc.callbacks.remove(on_gc)
        for obj, name, orig, _ in saved:
            setattr(obj, name, orig)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True)
    ap.add_argument("--seconds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from kvbench import run as runner
    from kvbench.serve import ProgramMissing, import_program

    try:
        import_program(ROOT)
    except ProgramMissing as e:
        print(f"kvbench: {e}", file=sys.stderr)
        return 2
    with capture() as got:
        rc = runner.main(["--workload", args.workload, "--seed", args.seed,
                          "--seconds", args.seconds, "--trace", "1"])
    if rc == 0:
        print(json.dumps(decompose(got["run"], got)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
