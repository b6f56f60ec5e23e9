"""Zero-dependency span tracer — one timing schema for sim and real runs.

The serving stack's timing claims are TIMELINE claims (the paper's Fig. 3
message timeline, Fig. 14's "transfer is 1.1 %/0.5 % of end-to-end
latency"), so the substrate records them as *spans*: named intervals on
named *tracks*, taken from ONE injectable clock.  A real run passes
``time.perf_counter``; the simulator passes its virtual clock; both
produce byte-identical schemas, so every downstream consumer (the
Chrome-trace exporter, the per-request breakdown, the stall forensics)
works on either without knowing which produced it.

Three primitives cover every call site:

* ``span(name, track=..., **attrs)`` — a context manager for scoped
  work (the serving loop's per-tick phases);
* ``phase(track, name, **attrs)`` — a *phase machine* per track: ends
  the track's open span and begins the next at the same timestamp, so a
  request's lifecycle (queue → prefill → queue.kv → transfer → decode)
  is a gap-free partition of its wall time — which is what lets the
  breakdown components sum EXACTLY to TTLT (obs/breakdown.py);
* ``complete(name, track, t0, t1)`` / ``instant(name, ...)`` — record
  an already-measured interval (the engine's per-layer transfer spans)
  or a point event (COMPLETE executed, connection torn).

Disabled mode (``Tracer(enabled=False)``, or the shared ``NULL_TRACER``)
is the hot-path default: every primitive returns immediately after one
attribute check, no allocation, no clock read — tests bound the overhead
at <5 % of a short serve-loop run.

``export_chrome()`` writes the standard Chrome trace-event JSON (load it
at ``chrome://tracing`` or https://ui.perfetto.dev): one process, one
named thread per track, "X" complete events with microsecond timestamps
— any serve run becomes a browsable timeline, the live analogue of the
paper's Fig. 3.

The wall-clock anchor: ``anchor()`` pairs the tracer's clock with
``time.time_ns()`` and keeps the tightest of five back-to-back reads as
``anchor_at = (t, wall_ns, err_ns)``: ``t`` the midpoint of the bracket
on the tracer's clock, ``wall_ns`` the wall clock read inside it,
``err_ns`` the bracket's width.  ``clear()`` takes one, so a run that
clears its warm-up spans has an anchor beside the spans it then records;
it is an attribute, never a span or an instant.  A device trace stamped
on the wall clock (``torch.profiler`` stamps kineto events with
CLOCK_REALTIME, ``time.time_ns()``'s clock) goes onto the spans' clock
by ``t + (ev_ns - wall_ns) * 1e-9``, good to ``err_ns`` plus the two
clocks' drift since the anchor.  A disabled tracer takes no anchor.

The JAX package's ``repro.obs.trace`` is the same tracer without the
anchor.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Iterable

__all__ = ["Span", "Tracer", "NULL_TRACER", "track_name"]

Clock = Callable[[], float]
Track = "tuple[str, ...] | str"


def track_name(track) -> str:
    """Canonical string form of a track key ("request/r0")."""
    if isinstance(track, tuple):
        return "/".join(str(p) for p in track)
    return str(track)


@dataclasses.dataclass
class Span:
    """One named interval on a track.  ``end()`` (or the context-manager
    exit) closes it; a still-open span has ``t1 is None``."""

    name: str
    track: Any
    t0: float
    t1: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    depth: int = 0              # context-manager nesting depth on this track
    _tracer: "Tracer | None" = dataclasses.field(default=None, repr=False)

    @property
    def duration_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, ts: float | None = None) -> "Span":
        if self.t1 is None and self._tracer is not None:
            self._tracer._end(self, ts)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """Shared no-op span: the disabled tracer hands out one instance."""

    __slots__ = ()
    name = ""
    track = ""
    t0 = 0.0
    t1 = 0.0
    attrs: dict = {}
    duration_s = 0.0

    def set(self, **attrs) -> "_NullSpan":
        return self

    def end(self, ts=None) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span recorder with an injectable clock and a near-zero disabled
    path.

    ``clock`` is any zero-arg callable returning seconds (monotonic or
    virtual); every timestamp the tracer — and anything sharing its
    clock — records comes from it, so spans from a sim run and a real
    run differ only in their numbers, never in their schema.
    """

    def __init__(self, *, clock: Clock | None = None, enabled: bool = True) -> None:
        self.enabled = enabled
        self.clock: Clock = clock or time.perf_counter
        self.spans: list[Span] = []          # closed, in end order
        self.instants: list[Span] = []       # point events (t1 == t0)
        self._open_phase: dict[Any, Span] = {}   # track -> open phase span
        self._stack: dict[Any, list[Span]] = {}  # track -> open scoped spans
        self.anchor_at: tuple[float, int, int] | None = None

    # ------------------------------------------------------------- clock
    def now(self) -> float:
        return self.clock()

    def anchor(self) -> tuple[float, int, int] | None:
        """Pair the tracer's clock with ``time.time_ns()``: of five
        brackets ``clock(); time_ns(); clock()`` keep the narrowest, as
        ``anchor_at = (midpoint, wall_ns, width_ns)``.  None when
        disabled (no clock is read)."""
        if not self.enabled:
            return None
        a, wall, b = min(((self.clock(), time.time_ns(), self.clock()) for _ in range(5)),
                         key=lambda r: r[2] - r[0])
        self.anchor_at = (0.5 * (a + b), wall, round((b - a) * 1e9))
        return self.anchor_at

    # ----------------------------------------------------- scoped spans
    def span(self, name: str, *, track="main", ts: float | None = None,
             **attrs) -> "Span | _NullSpan":
        """Begin a scoped span (use as a context manager).  Scoped spans
        nest: a span opened while another is open on the same track
        records the deeper ``depth``."""
        if not self.enabled:
            return _NULL_SPAN
        stack = self._stack.setdefault(track, [])
        s = Span(name, track, self.clock() if ts is None else ts,
                 attrs=dict(attrs), depth=len(stack), _tracer=self)
        stack.append(s)
        return s

    def _end(self, s: Span, ts: float | None = None) -> None:
        s.t1 = self.clock() if ts is None else ts
        stack = self._stack.get(s.track)
        if stack and s in stack:
            stack.remove(s)
        self.spans.append(s)

    # ----------------------------------------------------- phase machine
    def phase(self, track, name: str, *, ts: float | None = None,
              **attrs) -> "Span | _NullSpan":
        """End the open phase span on ``track`` (if any) and begin the
        next one at the SAME timestamp — consecutive phases share their
        boundary, so a track's phases partition its wall time with no
        gaps and no overlaps."""
        if not self.enabled:
            return _NULL_SPAN
        t = self.clock() if ts is None else ts
        prev = self._open_phase.pop(track, None)
        if prev is not None:
            prev.t1 = t
            self.spans.append(prev)
        s = Span(name, track, t, attrs=dict(attrs), _tracer=self)
        self._open_phase[track] = s
        return s

    def end_phase(self, track, *, ts: float | None = None, **attrs) -> "Span | None":
        """Close the open phase span on ``track`` (no-op when none)."""
        if not self.enabled:
            return None
        prev = self._open_phase.pop(track, None)
        if prev is None:
            return None
        prev.t1 = self.clock() if ts is None else ts
        prev.attrs.update(attrs)
        self.spans.append(prev)
        return prev

    def open_phase(self, track) -> Span | None:
        return self._open_phase.get(track)

    # ------------------------------------------------- direct recording
    def complete(self, name: str, track, t0: float, t1: float, **attrs) -> None:
        """Record an already-measured interval (e.g. a per-layer transfer
        span computed from the engine's own bookkeeping)."""
        if not self.enabled:
            return
        self.spans.append(Span(name, track, t0, t1, attrs=dict(attrs)))

    def instant(self, name: str, *, track="main", ts: float | None = None,
                **attrs) -> None:
        """Record a point event (COMPLETE executed, connection torn)."""
        if not self.enabled:
            return
        t = self.clock() if ts is None else ts
        self.instants.append(Span(name, track, t, t, attrs=dict(attrs)))

    # ------------------------------------------------------------ access
    def spans_of(self, track) -> list[Span]:
        """Closed spans on ``track``, ordered by start time."""
        return sorted((s for s in self.spans if s.track == track),
                      key=lambda s: (s.t0, s.depth))

    def tracks(self) -> list[Any]:
        seen: dict[Any, None] = {}
        for s in self.spans:
            seen.setdefault(s.track)
        for s in self.instants:
            seen.setdefault(s.track)
        return list(seen)

    def clear(self) -> None:
        """Drop every span and instant, and take a fresh clock anchor."""
        self.spans.clear()
        self.instants.clear()
        self._open_phase.clear()
        self._stack.clear()
        self.anchor()

    # ----------------------------------------------------- chrome export
    def to_chrome(self, *, process_name: str = "kvdirect") -> dict:
        """The trace as a Chrome trace-event JSON object (the
        ``{"traceEvents": [...]}`` container format, Perfetto-loadable).

        Tracks map to named threads of one process; timestamps are
        microseconds relative to the earliest recorded event, so sim
        (virtual-seconds) and real (perf_counter) traces render the
        same way."""
        events: list[dict] = []
        all_spans: Iterable[Span] = [*self.spans, *self.instants]
        t_base = min((s.t0 for s in all_spans), default=0.0)
        tids: dict[str, int] = {}

        def tid_of(track) -> int:
            key = track_name(track)
            if key not in tids:
                tids[key] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": 1,
                               "tid": tids[key], "args": {"name": key}})
            return tids[key]

        events.append({"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                       "args": {"name": process_name}})
        for s in sorted(self.spans, key=lambda s: s.t0):
            events.append({
                "ph": "X", "name": s.name, "pid": 1, "tid": tid_of(s.track),
                "ts": (s.t0 - t_base) * 1e6,
                "dur": ((s.t1 if s.t1 is not None else s.t0) - s.t0) * 1e6,
                "cat": track_name(s.track),
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            })
        for s in sorted(self.instants, key=lambda s: s.t0):
            events.append({
                "ph": "i", "s": "t", "name": s.name, "pid": 1,
                "tid": tid_of(s.track), "ts": (s.t0 - t_base) * 1e6,
                "cat": track_name(s.track),
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str, **kw) -> dict:
        """Write the Chrome trace JSON to ``path``; returns the object."""
        doc = self.to_chrome(**kw)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# The shared disabled tracer: the hot-path default everywhere a tracer is
# optional.  One instance so identity checks and the disabled fast path
# stay trivially cheap.
NULL_TRACER = Tracer(enabled=False)
