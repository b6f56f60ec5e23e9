"""``repro_torch.obs`` — unified tracing + metrics for the serving substrate.

One span tracer (injectable clock, near-zero disabled path, Chrome
trace-event export), one metrics registry (counters / gauges / windowed
histograms), a per-request Fig.-14 breakdown computed from spans.  See
docs/observability.md for the contract.

The JAX package's ``repro.obs`` also holds the ``BENCH_*.json`` per-PR
benchmark trajectory, which the port leaves out: its benchmark is
``kvbench/``.
"""
from repro_torch.obs.breakdown import (
    PHASE_CATEGORY,
    RequestBreakdown,
    all_request_breakdowns,
    mean_fractions,
    request_breakdown,
    spans_from_timeline,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer, track_name

__all__ = [
    "PHASE_CATEGORY",
    "RequestBreakdown",
    "all_request_breakdowns",
    "mean_fractions",
    "request_breakdown",
    "spans_from_timeline",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "track_name",
]
