"""The port's spans inside the decode step, the prefill and the KV pull, and
the tracer's wall-clock anchor (CPU, a smoke ``DecoderLM`` through
``DisaggService``).

These check structure only: which spans exist, where they sit and what
their attributes count.  How much of a step or a prefill each part takes
is read on the card: a smoke model's bookkeeping weighs far more here
than at full size.
"""
import time

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core.descriptors import ReadTxn
from repro_torch.models.registry import build_model
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.serving.disagg import DisaggService

ARCH = "deepseek-67b"
STEP_PARTS = ("step.pump", "step.rebuild", "step.launch", "step.sync")
PREFILL_PARTS = ("prefill.forward", "prefill.park", "prefill.digest", "prefill.quant")
PROMPTS = (40, 64, 23)       # 2, 2 and 1 blocks of 32 tokens
ANSWERS = (9, 4, 6)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init_params(seed=0)


def _prompt(cfg, i, n):
    return np.random.default_rng(100 + i).integers(0, cfg.vocab_size, n).astype(np.int32)


def serve(smoke, tracer=None, *, consume="full", quantize=False):
    """Three requests that join a running batch one by one and leave it at
    different steps; returns the service and the handles."""
    cfg, model, params = smoke
    svc = DisaggService(model, params, n_prefill=1, n_decode=1, num_blocks=64,
                        consume=consume, quantize_transfer=quantize, device="cpu",
                        tracer=tracer)
    submitted = []
    for tick in range(200):
        if tick in (0, 2, 5):
            i = len(submitted)
            submitted.append(svc.submit(_prompt(cfg, i, PROMPTS[i]), max_new=ANSWERS[i],
                                        dispatch="queued"))
        if svc.handles:
            svc.loop.tick()
        elif len(submitted) == 3:
            break
    assert all(h.done for h in submitted)
    return svc, submitted


def traced(smoke, **kw):
    tracer = Tracer()
    svc, handles = serve(smoke, tracer, **kw)
    return tracer, svc, handles


def named(tracer, *names):
    return [s for s in tracer.spans if s.name in names]


def inside(s, outer):
    return outer.t0 <= s.t0 and s.t1 <= outer.t1


def disjoint(spans):
    spans = sorted(spans, key=lambda s: s.t0)
    return all(a.t1 <= b.t0 for a, b in zip(spans, spans[1:]))


def phases(tracer, rid, name):
    return [s for s in tracer.spans if s.track == ("request", rid) and s.name == name]


# ------------------------------------------------------------ decode step
@pytest.mark.parametrize("consume", ["full", "layerwise"])
def test_every_step_has_launch_and_sync_children_at_depth_one(smoke, consume):
    tracer, _, _ = traced(smoke, consume=consume)
    steps = named(tracer, "tick.step")
    assert len(steps) >= 9
    parts = named(tracer, *STEP_PARTS)
    for step in steps:
        assert step.track == ("worker", "d0") and step.depth == 0
        kids = [s for s in parts if s.track == step.track and inside(s, step)]
        assert {"step.launch", "step.sync"} <= {s.name for s in kids}, step
        assert all(s.depth == 1 for s in kids)
    # every part of a step lies inside one
    for s in parts:
        assert any(inside(s, step) for step in steps), s


@pytest.mark.parametrize("consume", ["full", "layerwise"])
def test_a_steps_children_do_not_overlap(smoke, consume):
    tracer, _, _ = traced(smoke, consume=consume)
    parts = named(tracer, *STEP_PARTS)
    for step in named(tracer, "tick.step"):
        assert disjoint([s for s in parts if inside(s, step)])


def test_joins_and_leaves_rebuild_and_pulls_are_pumped_inside_steps(smoke):
    tracer, svc, _ = traced(smoke)
    cfg = svc.model.cfg
    rebuilds = named(tracer, "step.rebuild")
    # the first join, two more joins, two leaves, and a rebuild after the
    # last leave at most: membership changed on each
    assert 3 <= len(rebuilds) <= 6
    bs = svc.model.BLOCK_SIZE
    for s in rebuilds:
        a = s.attrs
        assert a["batch"] >= 1 and a["per_seq"] >= 1 + svc.decode.step_margin_blocks
        alloc = 2 * cfg.num_layers * a["batch"] * a["per_seq"] * bs * cfg.num_kv_heads \
            * cfg.head_dim * 2
        assert alloc < a["bytes"] <= 2 * alloc
    pumps = named(tracer, "step.pump")
    assert all(isinstance(s.attrs["txns"], int) and s.attrs["promoted"] >= 0 for s in pumps)
    # later requests' pulls ran inside steps, and were promoted there
    assert sum(s.attrs["txns"] for s in pumps) > 0
    assert sum(s.attrs["promoted"] for s in pumps) >= 1


def test_step_launch_counts_the_batch(smoke):
    tracer, _, _ = traced(smoke)
    steps = named(tracer, "tick.step")
    for launch in named(tracer, "step.launch"):
        step = next(s for s in steps if inside(launch, s))
        assert launch.attrs["batch"] == step.attrs["tokens"]


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("quantize", [False, True])
def test_prefill_parts_lie_inside_the_prefill_phase_and_do_not_overlap(smoke, quantize):
    tracer, _, handles = traced(smoke, quantize=quantize)
    want = {"prefill.forward", "prefill.park", "prefill.digest"} | (
        {"prefill.quant"} if quantize else set())
    for h, n in zip(handles, PROMPTS):
        (phase,) = phases(tracer, h.request_id, "prefill")
        mine = [s for s in named(tracer, *PREFILL_PARTS) if s.attrs["rid"] == h.request_id]
        assert {s.name for s in mine} == want and len(mine) == len(want)
        assert all(s.track == ("worker", "p0") and s.attrs["tokens"] == n for s in mine)
        assert all(inside(s, phase) for s in mine) and disjoint(mine)


def test_prefill_digest_counts_the_bytes_copied_to_the_host(smoke):
    tracer, svc, handles = traced(smoke)
    pw = svc.prefills["p0"]
    per_block = pw.cache.block_nbytes * 2 * pw.cache.num_layers
    bs = svc.model.BLOCK_SIZE
    for h, n in zip(handles, PROMPTS):
        (d,) = [s for s in named(tracer, "prefill.digest") if s.attrs["rid"] == h.request_id]
        assert d.attrs["bytes"] == -(-n // bs) * per_block


# ------------------------------------------------------------------- pull
@pytest.mark.parametrize("consume", ["full", "layerwise"])
def test_pull_span_counts_its_reads_bytes_and_pumps(smoke, consume):
    cfg, model, params = smoke
    tracer = Tracer()
    svc = DisaggService(model, params, n_prefill=1, n_decode=1, num_blocks=64,
                        consume=consume, device="cpu", tracer=tracer)
    reads: dict[str, int] = {}
    submit = svc.engine.submit

    def counting(txns):
        txns = list(txns)
        for t in txns:
            if isinstance(t, ReadTxn):
                reads[t.request_id] = reads.get(t.request_id, 0) + 1
        return submit(txns)
    svc.engine.submit = counting
    handles = [svc.submit(_prompt(cfg, i, n), max_new=3) for i, n in enumerate(PROMPTS)]
    svc.loop.run_until_idle()
    for h in handles:
        (pull,) = [s for s in tracer.spans
                   if s.name == "pull" and s.track == ("request", h.request_id)]
        assert pull.attrs["txns"] == reads[h.request_id] > 0
        assert pull.attrs["bytes"] == h.metrics.kv_bytes_pulled > 0
        assert pull.attrs["pumps"] >= 1 and pull.attrs["torn"] is False
        (phase,) = phases(tracer, h.request_id, "transfer")
        assert inside(pull, phase)
        layers = [s for s in tracer.spans if s.track == ("request", h.request_id)
                  and s.name.startswith("transfer.layer")]
        assert len(layers) == model.cfg.num_layers and all(inside(s, pull) for s in layers)


def test_torn_pull_records_torn_and_the_retry_its_own_bytes(smoke):
    cfg, model, params = smoke
    tracer = Tracer()
    svc = DisaggService(model, params, n_prefill=2, n_decode=1, num_blocks=64,
                        device="cpu", tracer=tracer)
    h = svc.submit(_prompt(cfg, 7, 61), max_new=2)
    victim = h.prefill_worker
    svc.admit_queued(only={h.request_id})
    svc.engine.tick(2)
    partial = svc.engine.pulled_bytes(h.request_id)
    assert partial > 0
    svc.fail_prefill_worker(victim)
    svc.loop.run_until_idle(only={h.request_id})
    assert h.done and h.retries == 1
    torn, whole = sorted((s for s in tracer.spans if s.name == "pull"), key=lambda s: s.t0)
    assert torn.attrs["torn"] is True and torn.attrs["txns"] == 2
    assert torn.attrs["bytes"] == partial and torn.attrs["pumps"] == 1
    assert whole.attrs["torn"] is False and torn.t1 <= whole.t0
    assert torn.attrs["bytes"] + whole.attrs["bytes"] == h.metrics.kv_bytes_pulled


def test_the_engine_records_no_pull_instants(smoke):
    tracer, _, _ = traced(smoke)
    names = {s.name for s in tracer.instants}
    assert not names & {"transfer.submit", "transfer.complete", "transfer.torn"}
    assert len(named(tracer, "pull")) == len(PROMPTS)


# ----------------------------------------------------------------- anchor
def test_clear_takes_an_anchor_and_records_nothing(smoke):
    tracer, _, _ = traced(smoke)
    assert tracer.spans
    before = time.time_ns()
    tracer.clear()
    after = time.time_ns()
    t, wall, err = tracer.anchor_at
    assert before <= wall <= after and 0 <= err < 1_000_000
    assert tracer.spans == [] and tracer.instants == []
    assert tracer.to_chrome()["traceEvents"][-1]["name"] == "process_name"


def test_anchor_maps_the_wall_clock_onto_the_tracers_clock():
    """A fake clock 1000 s behind the wall clock: a wall-clock stamp maps
    onto the tracer's clock by ``t + (ev_ns - wall_ns) * 1e-9``."""
    tracer = Tracer(clock=lambda: time.time_ns() * 1e-9 - 1000.0)
    t, wall, err = tracer.anchor()
    ev_ns = time.time_ns()
    mapped = t + (ev_ns - wall) * 1e-9
    assert mapped == pytest.approx(tracer.now(), abs=1e-3)
    assert tracer.anchor_at == (t, wall, err) and err < 1_000_000


def test_a_disabled_tracer_takes_no_anchor():
    reads = []
    tracer = Tracer(clock=lambda: reads.append(1) or 0.0, enabled=False)
    assert tracer.anchor() is None
    tracer.clear()
    assert tracer.anchor_at is None and reads == []
    assert NULL_TRACER.anchor_at is None


# ------------------------------------------------------- no behaviour change
@pytest.mark.parametrize("consume", ["full", "layerwise"])
def test_tokens_equal_traced_and_untraced(smoke, consume):
    _, plain = serve(smoke, consume=consume)
    tracer, _, handles = traced(smoke, consume=consume)
    assert [h.tokens for h in handles] == [h.tokens for h in plain]
    assert [h.metrics.kv_bytes_pulled for h in handles] == \
        [h.metrics.kv_bytes_pulled for h in plain]
    assert NULL_TRACER.spans == [] and NULL_TRACER.instants == []
