"""The device kernels a decode step launches: over the decode steps of the
profiled slice (``tick.step`` spans inside it), the mean count of device
kernel events, memcpy and memset left out, that start between the step's
first ``step.launch`` start and its last ``step.sync`` end.  A run whose
program records no such step, or without a device trace, reads nothing."""
from __future__ import annotations

import bisect


def _bounds(run, t0: float, t1: float) -> list[tuple[float, float]]:
    """(first launch start, last sync end) of each step inside [t0, t1]
    that has both, by track (the steps of one track do not overlap)."""
    steps: dict = {}
    for s in run.loop_spans("tick.step"):
        if t0 <= s.t0 and s.t1 <= t1:
            steps.setdefault(s.track, []).append([s.t0, s.t1, None, None])
    for iv in steps.values():
        iv.sort()
    for name, pick, slot in (("step.launch", min, 2), ("step.sync", max, 3)):
        for s in run.loop_spans(name):
            iv = steps.get(s.track, ())
            i = bisect.bisect_right([a for a, *_ in iv], s.t0) - 1
            if i >= 0 and s.t1 <= iv[i][1]:
                t = s.t0 if slot == 2 else s.t1
                iv[i][slot] = t if iv[i][slot] is None else pick(iv[i][slot], t)
    return [(a, b) for iv in steps.values() for *_, a, b in iv
            if a is not None and b is not None and a <= b]


def read(run):
    p = run.profile
    if p is None or not p.device:
        return None
    bounds = _bounds(run, p.t0, p.t1)
    if not bounds:
        return None
    starts = sorted(a for name, a, _ in p.device
                    if "memcpy" not in name.lower() and "memset" not in name.lower())
    return sum(bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
               for a, b in bounds) / len(bounds)
