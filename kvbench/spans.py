"""Arithmetic over the spans the program records inside a decode step
(``step.*`` children of the loop's ``tick.step``), a prefill (``prefill.*``,
tagged with the request's ``rid``) and a KV pull (``pull``, on the
request's track).  A run whose program records none of them reads nothing:
every function returns None there."""
from __future__ import annotations

import bisect

__all__ = ["STEP_PARTS", "window_steps", "within", "step_part_ms", "request_spans",
           "overlap_s"]

STEP_PARTS = ("step.pump", "step.rebuild", "step.launch", "step.sync")


def window_steps(run) -> list:
    """The ``tick.step`` spans that ended inside the window."""
    return [s for s in run.loop_spans("tick.step") if run.in_window(s.t1)]


def within(parts, outers) -> list:
    """The spans of ``parts`` that lie inside one of ``outers`` on the same
    track (the outers of a track do not overlap)."""
    by_track: dict = {}
    for s in sorted(outers, key=lambda s: s.t0):
        starts, ends = by_track.setdefault(s.track, ([], []))
        starts.append(s.t0)
        ends.append(s.t1)
    out = []
    for p in parts:
        starts, ends = by_track.get(p.track, ((), ()))
        i = bisect.bisect_right(starts, p.t0) - 1
        if i >= 0 and p.t1 <= ends[i]:
            out.append(p)
    return out


def step_part_ms(run, name: str) -> float | None:
    """The ``name`` children of the window's decode steps, summed, per step
    (a part a step does not run counts 0 there); None without steps or
    when the program records no step part at all."""
    steps = window_steps(run)
    parts = [s for s in run.spans or () if s.name in STEP_PARTS and s.t1 is not None]
    if not steps or not parts:
        return None
    mine = within([s for s in parts if s.name == name], steps)
    return 1e3 * sum(s.t1 - s.t0 for s in mine) / len(steps)


def request_spans(run, name: str) -> dict[str, list]:
    """rid -> the closed ``name`` spans of that request: those on its track,
    or tagged with its ``rid``."""
    out: dict[str, list] = {}
    for s in run.spans or ():
        if s.name != name or s.t1 is None:
            continue
        if isinstance(s.track, tuple) and s.track[0] == "request":
            rid = s.track[1]
        else:
            rid = s.attrs.get("rid")
        if rid is not None:
            out.setdefault(rid, []).append(s)
    return out


def overlap_s(a, b) -> float:
    """Length of the intersection of two lists of (start, end) intervals,
    each list without overlaps of its own."""
    a, b = sorted(a), sorted(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
