"""Tests of what the traced run reads.  On the CPU: the readers of the
program's spans inside a decode step, a prefill and a KV pull, and
``step_graph_pct``, each against arithmetic done by hand on a run built
here and each silent on a run whose program records none of these spans;
the decomposition; and the launch log that ``paged_attention_roofline``
reads, on the program's decode step in pieces.  On the card (marked
``cuda``, skipped without one) that launch log under CUDA-graph replay:

    python -m pytest -q -m cuda kvbench/test_kvbench_tracing.py
"""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from kvbench.bench import metric_reader
from kvbench.records import Profile, Req, Run

W = ("worker", "d0")
NEW = ("step_launch_ms", "step_sync_ms", "step_rebuild_ms", "step_pump_ms", "pull_ms_mean",
       "prefill_digest_ms_per_ktok", "step_launch_idle_pct")


def span(name, track, t0, t1, **attrs):
    return SimpleNamespace(name=name, track=track, t0=t0, t1=t1, attrs=attrs)


def step(t0, launch, sync, *, pump=0.0, rebuild=0.0, track=W):
    """A ``tick.step`` from ``t0`` with its children one after another and
    1 ms of its own at the end."""
    kids, t = [], t0
    for name, d in (("step.pump", pump), ("step.rebuild", rebuild), ("step.launch", launch),
                    ("step.sync", sync)):
        if d:
            kids.append(span(name, track, t, t + d))
            t += d
    return [span("tick.step", track, t0, t + 0.001), *kids]


def request(rid, due, prompt_len):
    return Req(rid, due, due, prompt_len, 4, [1, 2, 3, 4], [due + 0.1 * k for k in range(1, 5)])


def run_of(spans, reqs=(), profile=None, w0=10.0, w1=20.0):
    return Run("t", w0, w1, 40.0, 3.0, list(reqs), {}, list(spans), profile)


def steps_run():
    spans = (step(9.95, 0.08, 0.002, pump=0.004)           # ends at 10.037: counted
             + step(11.0, 0.07, 0.003, rebuild=0.01)
             + step(12.0, 0.06, 0.001, pump=0.002, rebuild=0.005)
             + step(19.95, 0.2, 0.05))                    # ends after the close
    spans.append(span("step.launch", ("worker", "p0"), 12.0, 12.5))   # no step on its track
    return run_of(spans)


def test_step_parts_per_step_in_the_window():
    run = steps_run()
    read = {n: metric_reader(n).read(run) for n in NEW[:4]}
    assert read["step_launch_ms"] == pytest.approx(1e3 * (0.08 + 0.07 + 0.06) / 3)
    assert read["step_sync_ms"] == pytest.approx(1e3 * (0.002 + 0.003 + 0.001) / 3)
    assert read["step_rebuild_ms"] == pytest.approx(1e3 * (0.01 + 0.005) / 3)
    assert read["step_pump_ms"] == pytest.approx(1e3 * (0.004 + 0.002) / 3)
    # with the steps' own time they make up decode_step_ms
    own = 1.0  # ms a step
    assert sum(read.values()) + own == pytest.approx(metric_reader("decode_step_ms").read(run))


def test_a_part_no_step_ran_reads_zero():
    run = run_of(step(11.0, 0.07, 0.003))
    assert metric_reader("step_rebuild_ms").read(run) == 0.0
    assert metric_reader("step_pump_ms").read(run) == 0.0


def test_pull_ms_mean_over_the_requests_due_in_the_window():
    reqs = [request("r0", 9.0, 70), request("r1", 12.0, 70), request("r2", 15.0, 70),
            request("r3", 21.0, 70)]
    spans = [span("pull", ("request", "r0"), 9.5, 9.9),        # due before the window
             span("pull", ("request", "r1"), 12.3, 12.7),
             span("pull", ("request", "r2"), 15.2, 15.3),      # torn, then retried
             span("pull", ("request", "r2"), 15.4, 15.6),
             span("pull", ("request", "r3"), 21.1, 21.9),      # due after the close
             span("transfer.layer0", ("request", "r1"), 12.3, 12.4)]
    got = metric_reader("pull_ms_mean").read(run_of(spans, reqs))
    assert got == pytest.approx(1e3 * (0.4 + 0.3) / 2)


def test_prefill_digest_per_ktok_of_the_requests_due_in_the_window():
    reqs = [request("r0", 11.0, 100), request("r1", 12.0, 300), request("r2", 9.0, 500),
            request("r3", 13.0, 900)]
    p = ("worker", "p0")
    spans = [span("prefill.digest", p, 11.1, 11.11, rid="r0"),
             span("prefill.digest", p, 12.1, 12.13, rid="r1"),
             span("prefill.digest", p, 9.1, 9.2, rid="r2"),
             span("prefill.forward", p, 13.0, 13.1, rid="r3"),
             span("prefill.digest", p, 14.0, 14.5, rid=None)]   # a hedge twin's
    got = metric_reader("prefill_digest_ms_per_ktok").read(run_of(spans, reqs))
    assert got == pytest.approx(1e3 * (0.01 + 0.03) / 0.4)


def test_step_launch_idle_pct_reads_idle_time_inside_launches():
    device = [("gemm", 12.0, 12.2), ("gemm", 12.5, 13.0), ("copy", 14.0, 16.0)]
    profile = Profile(12.0, 20.0, device, {}, busy_s=2.7)
    spans = (step(12.1, 0.6, 0.1)      # launch 12.1-12.7: idle 12.2-12.5
             + step(13.5, 1.0, 0.1)    # launch 13.5-14.5: idle 13.5-14.0
             + step(17.0, 1.0, 0.5))   # launch 17.0-18.0: all idle
    got = metric_reader("step_launch_idle_pct").read(run_of(spans, profile=profile))
    assert got == pytest.approx(100.0 * (0.3 + 0.5 + 1.0) / 8.0)
    # no more than the slice's idle share
    assert got <= metric_reader("device_idle_pct").read(run_of(spans, profile=profile))


@pytest.mark.parametrize("name", NEW)
def test_a_run_without_the_programs_inner_spans_reads_nothing(name):
    """What the parent's program records: the loop's and the lifecycle's
    spans, the engine's per-layer spans, a profiled slice."""
    reqs = [request("r1", 12.0, 70)]
    spans = [span("tick.step", W, 11.0, 11.1, batch=1, tokens=1),
             span("tick", "loop", 10.9, 11.2),
             span("prefill", ("request", "r1"), 12.0, 12.1),
             span("queue.kv", ("request", "r1"), 12.1, 12.2),
             span("transfer", ("request", "r1"), 12.2, 12.6),
             span("transfer.layer0", ("request", "r1"), 12.2, 12.3)]
    profile = Profile(12.0, 20.0, [("gemm", 12.0, 12.2)], {}, busy_s=0.2)
    assert metric_reader(name).read(run_of(spans, reqs, profile)) is None
    assert metric_reader(name).read(run_of([], reqs)) is None


# ------------------------------------------------------------ decomposition
def _handoff_run():
    """Two requests due in the window: r1 pulled in two pumps, r2 torn once
    and pulled again; their prefills split into parts."""
    R1, R2, P = ("request", "r1"), ("request", "r2"), ("worker", "p0")
    spans = (step(11.0, 0.07, 0.003, pump=0.004) + step(12.0, 0.05, 0.002, rebuild=0.01)
             + [span("prefill", R1, 11.0, 11.1), span("queue.kv", R1, 11.1, 11.12),
                span("transfer", R1, 11.12, 11.42),
                span("pull", R1, 11.13, 11.4, txns=96, pumps=2, bytes=3000, torn=False),
                span("prefill.forward", P, 11.0, 11.07, rid="r1", tokens=70),
                span("prefill.park", P, 11.07, 11.08, rid="r1", tokens=70),
                span("prefill.digest", P, 11.08, 11.1, rid="r1", tokens=70, bytes=600),
                span("prefill", R2, 13.0, 13.2), span("queue.kv", R2, 13.2, 13.3),
                span("transfer", R2, 13.3, 13.8),
                span("pull", R2, 13.3, 13.4, txns=10, pumps=1, bytes=100, torn=True),
                span("pull", R2, 13.5, 13.75, txns=96, pumps=3, bytes=3000, torn=False),
                span("prefill.forward", P, 13.0, 13.15, rid="r2", tokens=130),
                span("prefill.digest", P, 13.15, 13.19, rid="r2", tokens=130, bytes=900)])
    for s in spans:
        if s.name == "step.rebuild":
            s.attrs.update(batch=3, per_seq=4, bytes=5000)
        if s.name == "step.pump":
            s.attrs.update(txns=32, promoted=1)
        if s.name == "step.launch":
            s.attrs.update(batch=3)
    return run_of(spans, [request("r1", 11.0, 70), request("r2", 13.0, 130)])


def test_decompose_splits_the_step_the_handoff_and_the_prefill():
    from kvbench.decompose import decompose

    run = _handoff_run()
    got = {"anchor": (15.0, 1_000_000_000_000, 120), "slice_t0": 16.0,
           "trace_start_ns": 1_000_999_950_000, "wall_before_start_ns": 1_000_999_900_000,
           "wall_after_start_ns": 1_001_000_000_000,
           "gc": [(2, 12.5, 12.51), (0, 13.0, 13.0001), (1, 25.0, 25.1)]}
    d = decompose(run, got)
    st = d["step"]
    assert st["steps"] == 2 and st["batch"] == 3
    assert st["step_ms"] == pytest.approx(1e3 * (0.078 + 0.063) / 2)
    assert st["step.launch_ms"] == pytest.approx(1e3 * 0.12 / 2)
    assert st["parts_share"] == pytest.approx((0.077 + 0.062) / (0.078 + 0.063))
    assert st["rebuild"] == {"n": 1, "ms": pytest.approx(10.0), "bytes": 5000, "batch": 3,
                             "per_seq": 4}
    assert st["pump"] == {"n": 1, "txns": 32, "promoted": 1}
    h = d["handoff"]
    assert h["requests"] == 2
    assert h["queue_kv_ms"] == pytest.approx(1e3 * (0.02 + 0.1) / 2)
    assert h["handoff_ms"] == pytest.approx(1e3 * (0.32 + 0.6) / 2)
    assert h["pull_ms"] == pytest.approx(1e3 * (0.27 + 0.35) / 2)
    assert h["promote_ms"] == pytest.approx(1e3 * (0.03 + 0.15) / 2)
    assert (h["txns"], h["pumps"], h["pumps_least"], h["pumps_most"]) == (101, 3, 2, 4)
    assert h["bytes"] == 3050 and h["torn"] == 1 and h["inside_transfer"] == 1.0
    assert h["steps_a_pull"] == pytest.approx(h["pull_ms"] / st["step_ms"])
    p = d["prefill"]
    assert p["prefill_ms_per_ktok"] == pytest.approx(1e3 * 0.3 / 0.2)
    assert p["prefill.forward_share"] == pytest.approx(0.22 / 0.3)
    assert p["prefill.digest_share"] == pytest.approx(0.06 / 0.3)
    assert p["prefill.quant_share"] == 0.0
    assert p["covered"] == pytest.approx(0.29 / 0.3) and p["digest_bytes"] == 750
    # the harness maps an event 50 us late against the anchor's mapping
    assert d["clock"]["delta_ms"] == pytest.approx(0.05)
    assert (d["clock"]["kineto_start_in_start_us"], d["clock"]["start_us"]) == (50.0, 100.0)
    assert d["gc"]["collections"] == [1, 0, 1]
    assert d["gc"]["gen2_pause_ms"] == pytest.approx(10.0)


def test_decompose_reads_only_what_a_parent_run_has():
    from kvbench.decompose import decompose

    R1 = ("request", "r1")
    spans = [span("tick.step", W, 11.0, 11.1, batch=1, tokens=1),
             span("prefill", R1, 11.0, 11.1), span("queue.kv", R1, 11.1, 11.2),
             span("transfer", R1, 11.2, 11.6), span("transfer.layer0", R1, 11.2, 11.3)]
    d = decompose(run_of(spans, [request("r1", 11.0, 70)]))
    assert d["step"] == {"steps": 1, "step_ms": pytest.approx(100.0), "batch": None}
    assert d["handoff"] == {"requests": 1, "handoff_ms": pytest.approx(500.0),
                            "queue_kv_ms": pytest.approx(100.0)}
    assert d["prefill"] == {"requests": 1, "prefill_ms_per_ktok": pytest.approx(1e3 * 0.1 / 0.07)}
    assert d["clock"] is None and d["gc"] is None
    assert d["spans_per_s"]["inner"] == 0
    empty = decompose(run_of([]))
    assert empty["step"] is empty["handoff"] is empty["prefill"] is None


def test_capture_around_a_traced_cpu_run():
    """A whole traced run at test size: the decomposition reads the
    program's spans; the captured hooks are undone afterwards."""
    import time

    import torch

    from kvbench import profiling, serve
    from kvbench.decompose import capture, decompose
    from kvbench.test_kvbench_correct import _small
    from repro_torch.obs.trace import Tracer

    cell, size = _small("yi9b.chat")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with capture() as got:
            serve.run_cell(cell, seed=2147483901, seconds=2.0, trace=True,
                           t_start=time.perf_counter(), device="cpu", model_cfg=size,
                           log=lambda m: None)
    finally:
        torch.set_num_threads(n)
    assert (serve.Run, Tracer.anchor, profiling.Slice.start) == (
        Run, Tracer.__dict__["anchor"], profiling.Slice.__dict__["start"])
    d = decompose(got["run"], got)
    assert got["anchor"][2] < 1_000_000
    assert 0.95 <= d["step"]["parts_share"] <= 1.0
    assert d["handoff"]["inside_transfer"] == 1.0 and d["handoff"]["torn"] == 0
    assert d["handoff"]["pull_ms"] <= d["handoff"]["handoff_ms"]
    assert d["handoff"]["pumps_least"] >= 1
    assert 0.95 <= d["prefill"]["covered"] <= 1.0
    assert d["clock"] is None  # no profiled slice on the CPU
    assert d["spans_per_s"]["inner"] > 0 and len(d["gc"]["collections"]) == 3


# ------------------------------------------------------------ step_graph_pct
def graph_steps(*modes, after="replay"):
    """One step a second from 11 s, its ``step.launch`` marked with each of
    ``modes`` in turn (None: no ``graph`` attribute), and a step after the
    close marked ``after``."""
    spans = []
    for i, mode in enumerate((*modes, after)):
        st = step(11.0 + i if i < len(modes) else 19.95, 0.05, 0.002)
        if mode is not None:
            st[1].attrs["graph"] = mode
        spans += st
    return run_of(spans)


@pytest.mark.parametrize("modes,want", [
    (("replay", "replay", "replay"), 100.0),
    (("capture", "replay", "eager", "replay"), 50.0),
    (("eager", "eager"), 0.0),
    (("capture", None), 0.0),
])
def test_step_graph_pct_counts_the_replayed_steps_in_the_window(modes, want):
    assert metric_reader("step_graph_pct").read(graph_steps(*modes)) == pytest.approx(want)


def test_step_graph_pct_reads_nothing_without_the_attribute():
    assert metric_reader("step_graph_pct").read(graph_steps(None, None, after=None)) is None
    parent = [span("tick.step", W, 11.0, 11.1, batch=1, tokens=1),
              span("step.launch", W, 11.0, 11.05, batch=1)]
    assert metric_reader("step_graph_pct").read(run_of(parent, [request("r1", 12.0, 70)])) \
        is None
    assert metric_reader("step_graph_pct").read(run_of([])) is None


# ------------------------------------------------- the launch log, per step
def _launches_per_step(cell_name, device):
    """The cell's configuration at its test size served on ``device`` with
    a tracer: one request to warm up (on the card its first step captures
    the graphs), then three of different lengths, which leave the decode
    batch one by one, with ``profiling.LaunchLog`` on.  Returns the number of
    layers, the decode steps' ``step.launch`` spans in order, and the
    paged_attention launches the log recorded."""
    import time

    import numpy as np

    from kvbench.bench import load_cell
    from kvbench.profiling import LaunchLog
    from kvbench.serve import Program, cpu_config, import_program

    import_program()
    from repro_torch.obs.trace import Tracer

    cell = load_cell(cell_name)
    size = cpu_config(cell.config)
    prog = Program.build(cell, seed=2147483907, device=device, model_cfg=size)
    tracer = Tracer(clock=time.perf_counter)
    svc = prog.service(tracer)
    rng = np.random.default_rng(2147483911)

    def serve(*requests):
        for n, out in requests:
            svc.submit(rng.integers(0, size.vocab_size, n, dtype=np.int64), max_new=out,
                       dispatch="queued")
        svc.loop.run_until_idle()
        prog.sync()

    serve((40, 3))
    tracer.clear()
    log = LaunchLog()
    log.install()
    log.on = True
    try:
        serve((33, 4), (70, 9), (150, 14))
    finally:
        log.on = False
        log.uninstall()
    steps = sorted((s for s in tracer.spans if s.name == "step.launch"), key=lambda s: s.t0)
    return size.num_layers, steps, log.settle()["paged_attention"]


def _one_launch_a_layer_a_step(layers, steps, calls):
    assert steps and len(calls) == layers * len(steps)
    assert [c["b"] for c in calls] == [s.attrs["batch"] for s in steps for _ in range(layers)]
    assert len({s.attrs["batch"] for s in steps}) > 1      # the batch changed
    for i in range(len(steps)):                            # one context tensor a step
        assert len({c["keys"] for c in calls[i * layers:(i + 1) * layers]}) == 1


@pytest.mark.parametrize("cell", ["yi9b.chat", "granite-moe.chat"])
def test_the_launch_log_sees_one_paged_attention_a_layer_a_step(cell):
    """On the CPU the decode step runs as its pieces, paged attention
    between them, as the card's replay does: the log records each layer's
    launch of each step, with the step's batch."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        layers, steps, calls = _launches_per_step(cell, "cpu")
    finally:
        torch.set_num_threads(n)
    assert {s.attrs["graph"] for s in steps} == {"eager"}
    _one_launch_a_layer_a_step(layers, steps, calls)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["yi9b.chat", "granite-moe.chat"])
def test_the_launch_log_sees_one_paged_attention_a_layer_a_replayed_step(cell):
    """On the card, where the pieces replay as CUDA graphs and paged
    attention runs eagerly between them: every step after the capture is
    a replay, and the log still records each layer's launch of each step
    (what ``paged_attention_roofline`` divides by the kernel's device
    time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphs and the kernels run on the card only)")
    layers, steps, calls = _launches_per_step(cell, "cuda")
    assert {s.attrs["graph"] for s in steps} == {"replay"}
    _one_launch_a_layer_a_step(layers, steps, calls)
