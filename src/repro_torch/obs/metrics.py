"""Metrics registry — counters, gauges, and windowed histograms.

The aggregate companion to the span tracer (obs/trace.py): spans answer
"what did THIS request's timeline look like", the registry answers "what
has the system been doing lately" — dispatch/admission/token counts per
serve-loop phase, engine bytes and teardown totals, router decisions and
hedge outcomes, and latency distributions (TTFT/TTLT/TBT) over a sliding
window with p50/p90/p99.

Everything is in-process and allocation-light: a counter is one float, a
histogram is one bounded deque.  ``snapshot()`` renders the whole
registry to plain dicts for printing (launch/serve.py's end-of-run
report), for the stall forensics attached to ``ServeLoopStalled``, and
for tests.

Copy of ``src/repro/obs/metrics.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Iterable

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


@dataclasses.dataclass
class Counter:
    """Monotonic accumulator (events, bytes, retries)."""

    name: str
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Last-write-wins instantaneous value (queue depth, free blocks)."""

    name: str
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Windowed distribution: the last ``window`` observations plus
    all-time count/total.  Percentiles use the nearest-rank method over
    the window — deterministic, no interpolation."""

    __slots__ = ("name", "window", "count", "total")

    def __init__(self, name: str, window: int = 1024) -> None:
        self.name = name
        self.window: collections.deque[float] = collections.deque(maxlen=window)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.window.append(float(v))
        self.count += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the current window (q in 0..100)."""
        if not self.window:
            return 0.0
        vals = sorted(self.window)
        rank = max(1, -(-len(vals) * q // 100))  # ceil(n*q/100), min 1
        return vals[min(len(vals), int(rank)) - 1]

    def summary(self) -> dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "max": max(self.window) if self.window else 0.0,
        }


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Instruments are created on first touch so call sites never need
    registration boilerplate; the convenience forms (``inc`` /
    ``set_gauge`` / ``observe``) are what the serving path uses inline.
    """

    def __init__(self, *, histogram_window: int = 1024) -> None:
        self.histogram_window = histogram_window
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # --------------------------------------------------------- creation
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, *, window: int | None = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(
                name, window or self.histogram_window)
        return h

    # ------------------------------------------------------ convenience
    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # ----------------------------------------------------------- export
    def counters(self, prefix: str = "") -> dict[str, float]:
        return {n: c.value for n, c in sorted(self._counters.items())
                if n.startswith(prefix)}

    def snapshot(self) -> dict[str, dict]:
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self._histograms.items())},
        }

    def format(self, *, prefixes: Iterable[str] = ()) -> str:
        """Human-readable one-metric-per-line rendering (optionally
        restricted to name prefixes) — what launch/serve.py prints."""
        pre = tuple(prefixes)

        def keep(name: str) -> bool:
            return not pre or any(name.startswith(p) for p in pre)

        lines = []
        for n, c in sorted(self._counters.items()):
            if keep(n):
                v = int(c.value) if c.value == int(c.value) else c.value
                lines.append(f"{n} = {v}")
        for n, g in sorted(self._gauges.items()):
            if keep(n):
                lines.append(f"{n} = {g.value:g}")
        for n, h in sorted(self._histograms.items()):
            if keep(n):
                s = h.summary()
                lines.append(
                    f"{n}: n={s['count']} mean={s['mean']:.6f} "
                    f"p50={s['p50']:.6f} p90={s['p90']:.6f} p99={s['p99']:.6f}")
        return "\n".join(lines)
