"""What a run leaves for the metric readers: the requests' timelines, the
window, the program's spans and, in a traced run, the profiled slice.
Every time is in seconds on the host's ``time.perf_counter`` clock, the one
the service stamps its tokens and spans with."""
from __future__ import annotations

import dataclasses
import math

__all__ = ["Req", "Profile", "Run", "percentile", "PEAKS"]

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W).
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between
    order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Req:
    rid: str
    due: float
    submitted: float
    prompt_len: int
    output_len: int           # tokens due in all, the first included
    tokens: list[int]
    times: list[float]        # when each token reached the handle
    failed: bool = False      # refused, failed, or unanswered at the deadline
    prompt: object = None     # the prompt's token ids (numpy), for the comparison

    @property
    def done(self) -> bool:
        return not self.failed and len(self.tokens) >= self.output_len


@dataclasses.dataclass
class Profile:
    """The profiled slice of a traced run."""

    t0: float
    t1: float
    device: list[tuple[str, float, float]]   # (name, start, end) of each device op
    launches: dict[str, list[dict]]          # kernel -> shapes of each launch in the slice
    busy_s: float = 0.0                      # union of the device ops' intervals


@dataclasses.dataclass
class Run:
    cell: str
    w0: float
    w1: float
    deadline: float           # the end of the drain: what an unanswered request is charged
    setup_s: float
    requests: list[Req]
    model: dict               # the configuration file's "run" block
    spans: list | None = None     # the program's tracer spans (traced run)
    profile: Profile | None = None
    reference: object = None      # the configuration's reference module (its FLOP counts)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def in_window(self, t: float) -> bool:
        return self.w0 <= t < self.w1

    def due_in_window(self) -> list[Req]:
        return [r for r in self.requests if self.in_window(r.due)]

    def lifecycle(self) -> dict[str, dict[str, list]]:
        """rid -> phase name -> that request's closed phase spans."""
        out: dict[str, dict[str, list]] = {}
        for s in self.spans or ():
            if isinstance(s.track, tuple) and s.track[0] == "request" and s.t1 is not None:
                out.setdefault(s.track[1], {}).setdefault(s.name, []).append(s)
        return out

    def loop_spans(self, name: str) -> list:
        return [s for s in self.spans or () if s.name == name and s.t1 is not None]
