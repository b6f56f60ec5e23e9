"""Per-request latency breakdown — the live Fig. 14.

The serving path records each request's lifecycle as a gap-free phase
partition on its tracer track (``("request", rid)``, see the phase
machine in obs/trace.py):

    queue → prefill → queue.kv → transfer → decode
      (failover may cycle back through queue/queue.kv)

This module folds those spans into the paper's Fig. 14 components —
queue / prefill / transfer / decode — whose sum IS the request's
time-to-last-token: the phases share boundary timestamps, so the
decomposition is exact, not approximate.  ``fig14_breakdown.py`` uses it
to cross-check the live substrate against the discrete-event simulator,
and the same function works on a sim-produced tracer because both sides
share one span schema.

``spans_from_timeline`` is the bridge for code that records coarse
timestamps instead of spans (the simulator's ``Request`` timeline
fields): it re-emits the same phase schema onto a tracer, so every
consumer — Chrome export, breakdown, tests — sees one format.

Layerwise note: under ``consume="layerwise"`` a request's first decode
step overlaps the tail of its pull; the phase machine attributes the
overlap to *transfer* (the transfer phase ends at promotion, which for
a streamed join is when its first step completes), so components still
partition wall time — the per-layer ``transfer.layer`` sub-spans keep
the true wire timeline visible.

Copy of ``src/repro/obs/breakdown.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.trace import Tracer

__all__ = ["PHASE_CATEGORY", "RequestBreakdown", "request_breakdown",
           "all_request_breakdowns", "mean_fractions", "spans_from_timeline"]

# Phase-span name -> Fig. 14 component.  Names outside this map (e.g.
# the engine's per-layer "transfer.layer" sub-spans) are informational
# overlays, not partition members, and are excluded from the sums.
PHASE_CATEGORY: dict[str, str] = {
    "queue": "queue_s",
    "queue.kv": "queue_s",       # prefill done, waiting for decode admission
    "queue.decode": "queue_s",   # admitted, waiting for a decode slot
    "prefill": "prefill_s",
    "transfer": "transfer_s",
    "decode": "decode_s",
}
COMPONENTS = ("queue_s", "prefill_s", "transfer_s", "decode_s")


@dataclasses.dataclass
class RequestBreakdown:
    """One request's Fig. 14 decomposition (seconds on the trace clock)."""

    request_id: str
    queue_s: float = 0.0
    prefill_s: float = 0.0
    transfer_s: float = 0.0
    decode_s: float = 0.0
    ttlt_s: float = 0.0          # first phase start -> last phase end
    n_spans: int = 0
    n_layer_spans: int = 0       # per-layer transfer sub-spans observed

    def components(self) -> dict[str, float]:
        return {k: getattr(self, k) for k in COMPONENTS}

    @property
    def total_s(self) -> float:
        return sum(self.components().values())

    def fractions(self) -> dict[str, float]:
        tot = max(self.total_s, 1e-12)
        return {k: v / tot for k, v in self.components().items()}


def request_breakdown(tracer: Tracer, request_id: str) -> RequestBreakdown:
    """Fold the closed phase spans of one request's track into Fig. 14
    components.  Because consecutive phases share boundary timestamps,
    ``total_s == ttlt_s`` exactly (up to float addition error)."""
    track = ("request", request_id)
    out = RequestBreakdown(request_id)
    t_lo: float | None = None
    t_hi: float | None = None
    for s in tracer.spans_of(track):
        if s.t1 is None:
            continue
        if s.name.startswith("transfer.layer"):
            out.n_layer_spans += 1
            continue
        cat = PHASE_CATEGORY.get(s.name)
        if cat is None:
            continue
        setattr(out, cat, getattr(out, cat) + (s.t1 - s.t0))
        out.n_spans += 1
        t_lo = s.t0 if t_lo is None else min(t_lo, s.t0)
        t_hi = s.t1 if t_hi is None else max(t_hi, s.t1)
    if t_lo is not None and t_hi is not None:
        out.ttlt_s = t_hi - t_lo
    return out


def all_request_breakdowns(tracer: Tracer) -> dict[str, RequestBreakdown]:
    """Breakdowns for every request track with at least one closed span."""
    rids: dict[str, None] = {}
    for s in tracer.spans:
        if isinstance(s.track, tuple) and len(s.track) == 2 \
                and s.track[0] == "request":
            rids.setdefault(s.track[1])
    return {rid: request_breakdown(tracer, rid) for rid in rids}


def mean_fractions(breakdowns) -> dict[str, float]:
    """Mean per-component fraction across requests — the Fig. 14 bar."""
    items = list(breakdowns.values() if isinstance(breakdowns, dict)
                 else breakdowns)
    items = [b for b in items if b.total_s > 0]
    if not items:
        return {k: 0.0 for k in COMPONENTS}
    acc = {k: 0.0 for k in COMPONENTS}
    for b in items:
        for k, v in b.fractions().items():
            acc[k] += v
    return {k: v / len(items) for k, v in acc.items()}


def spans_from_timeline(tracer: Tracer, req) -> None:
    """Emit the standard request phase spans from a ``Request``'s coarse
    timeline fields (arrival/prefill/transfer/decode timestamps) — the
    simulator's records rendered into the live schema, so sim and real
    traces are directly comparable (and Chrome-exportable) side by side.
    """
    track = ("request", req.request_id)
    pairs = [
        ("queue", req.arrival_s, req.prefill_start_s),
        ("prefill", req.prefill_start_s, req.prefill_end_s),
        ("queue.kv", req.prefill_end_s, req.transfer_start_s),
        ("transfer", req.transfer_start_s, req.transfer_end_s),
        ("queue.decode", req.transfer_end_s, req.decode_start_s),
        ("decode", req.decode_start_s, req.done_s),
    ]
    for name, t0, t1 in pairs:
        if t0 is None or t1 is None:
            continue
        tracer.complete(name, track, t0, max(t0, t1))
