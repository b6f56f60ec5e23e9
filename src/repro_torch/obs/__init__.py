"""``repro_torch.obs`` — unified tracing + metrics for the serving substrate.

One span tracer (injectable clock, near-zero disabled path, Chrome
trace-event export), one metrics registry (counters / gauges / windowed
histograms), a per-request Fig.-14 breakdown computed from spans, and
the ``BENCH_*.json`` per-PR benchmark trajectory.  See
docs/observability.md for the contract.

Copy of ``src/repro/obs/__init__.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.obs.bench import (
    BENCH_SCHEMA_VERSION,
    BenchEntry,
    BenchTrajectory,
    bench_path,
    load_trajectory,
    validate_bench,
)
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
    "BENCH_SCHEMA_VERSION",
    "BenchEntry",
    "BenchTrajectory",
    "bench_path",
    "load_trajectory",
    "validate_bench",
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
