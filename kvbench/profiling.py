"""The traced run's device view: ``torch.profiler`` (CUDA activity) over a
slice at the end of the window, and a log of the three main-path kernels'
launch shapes in it.

The log wraps the names the program's call sites look up
(``models.flash.flash_prefill``, ``models.attention.paged_attention``,
``core.transfer_engine.kv_pull``) with a recorder of each launch's shapes;
the roofline readers work out the operations and bytes from those shapes
with formulas of their own.  Only a traced run installs it, and only
while the profiler runs.  It reads nothing from the device meanwhile:
the decode contexts are kept as the tensors the program made and summed
once the window is over.
"""
from __future__ import annotations

import time

from kvbench.records import Profile

__all__ = ["LaunchLog", "Slice", "union_s", "idle_gaps", "breakdown"]


class LaunchLog:
    SITES = (("repro_torch.models.flash", "flash_prefill"),
             ("repro_torch.models.attention", "paged_attention"),
             ("repro_torch.core.transfer_engine", "kv_pull"))

    def __init__(self) -> None:
        self.on = False
        self.calls: dict[str, list[dict]] = {name: [] for _, name in self.SITES}
        self._saved: list = []

    def install(self) -> None:
        import importlib

        for modname, name in self.SITES:
            mod = importlib.import_module(modname)
            orig = getattr(mod, name)
            self._saved.append((mod, name, orig))
            setattr(mod, name, self._wrap(name, orig))

    def uninstall(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved.clear()

    def _wrap(self, name, orig):
        record = getattr(self, "_" + name)

        def wrapper(*args, **kwargs):
            if self.on:
                self.calls[name].append(record(*args, **kwargs))
            return orig(*args, **kwargs)
        return wrapper

    @staticmethod
    def _flash_prefill(q, k, v, *, causal=True, sliding_window=0, prefix_len=0, **_):
        b, s, h, d = q.shape
        return {"b": b, "s": s, "t": k.shape[1], "h": h, "g": k.shape[2], "d": d,
                "itemsize": q.element_size(), "causal": bool(causal),
                "window": int(sliding_window), "prefix": int(prefix_len)}

    @staticmethod
    def _paged_attention(q, k_pages, v_pages, block_tables, context_lens, **_):
        b, h, d = q.shape
        return {"b": b, "h": h, "d": d, "g": k_pages.shape[3], "per_seq": k_pages.shape[1],
                "itemsize": q.element_size(), "context_lens": context_lens}

    @staticmethod
    def _kv_pull(src_pages, dst_pages, src_ids, dst_ids, *_, **__):
        def page(p):
            return p[0].numel() * p.element_size() if len(p) else 0
        return {"n": int(src_ids.shape[0]), "src_page_bytes": page(src_pages),
                "dst_page_bytes": page(dst_pages)}

    def settle(self) -> dict[str, list[dict]]:
        """The slice's launches with the decode contexts summed to ``keys``."""
        import torch

        pa = self.calls["paged_attention"]
        if pa:
            sums = torch.stack([c.pop("context_lens").long().sum() for c in pa]).tolist()
            for c, n in zip(pa, sums):
                c["keys"] = int(n)
        return {k: list(v) for k, v in self.calls.items()}


def union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def idle_gaps(device, t0: float, t1: float) -> list[tuple[float, float]]:
    """The stretches of [t0, t1] in which no device operation ran."""
    gaps, cur = [], t0
    for a, b in sorted((max(a, t0), min(b, t1)) for _, a, b in device):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        gaps.append((cur, t1))
    return gaps


class Slice:
    """``start()`` and ``end()`` around the profiled stretch of the window,
    then ``stop()`` once the window's requests are served: stopping the
    profiler holds the host for seconds, so it waits until no request
    being timed is held with it, and what runs between ``end()`` and
    ``stop()`` is not read."""

    def __init__(self, log: LaunchLog | None) -> None:
        self.log = log
        self.prof = None
        self.t0 = self.t1 = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once in set-up: its first start loads
        and initialises the tracing library."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()
        if self.log is not None:
            self.log.install()
            self.log.on = True

    def end(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if self.log is not None:
            self.log.on = False
            self.log.uninstall()

    def stop(self) -> None:
        if self.t1 is None:
            self.end()
        self.prof.stop()

    def result(self) -> Profile:
        """The slice's device operations on the host clock: the profiler's
        raw events (no per-event Python objects are built), their times
        counted from the trace's start, which ``t0`` stamps; those that
        start after ``t1`` (launched once the log was off) are left out."""
        from torch.autograd import DeviceType

        res = self.prof.profiler.kineto_results
        if hasattr(res, "trace_start_ns"):
            base, scale, start, dur = res.trace_start_ns(), 1e-9, "start_ns", "duration_ns"
        else:  # older PyTorch: microseconds
            base, scale, start, dur = res.trace_start_us(), 1e-6, "start_us", "duration_us"
        device = []
        for ev in res.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            a = self.t0 + (getattr(ev, start)() - base) * scale
            if a < self.t1:
                device.append((ev.name(), a, a + getattr(ev, dur)() * scale))
        launches = self.log.settle() if self.log is not None else {}
        clipped = [(max(a, self.t0), min(b, self.t1)) for _, a, b in device]
        return Profile(self.t0, self.t1, device, launches,
                       busy_s=union_s([(a, b) for a, b in clipped if b > a]))


_PARTS = ("tick.dispatch", "tick.retire", "tick.fleet", "tick.revive", "tick.admit",
          "tick.transfer", "tick.promote", "tick.step")


def _labeller(spans):
    """label(t): the loop part (``tick.*``) open at t, else "tick" inside a
    tick, else "outside tick".  The parts of a tick do not overlap, nor do
    the ticks, so each is one sorted list searched by bisection."""
    import bisect

    def index(names):
        iv = sorted((s.t0, s.t1, s.name) for s in spans or ()
                    if s.name in names and s.t1 is not None)
        return [a for a, _, _ in iv], iv
    parts, ticks = index(_PARTS), index(("tick",))

    def find(t, idx):
        starts, iv = idx
        i = bisect.bisect_right(starts, t) - 1
        return iv[i][2] if i >= 0 and iv[i][1] >= t else None

    def label(t):
        return find(t, parts) or find(t, ticks) or "outside tick"
    return label


def breakdown(profile: Profile, spans) -> dict:
    """The device operations that took most time, by name, and the device's
    idle time by the loop part open in the middle of each gap, ten of each."""
    ops: dict[str, float] = {}
    for name, a, b in profile.device:
        ops[name[:160]] = ops.get(name[:160], 0.0) + (b - a)
    label = _labeller(spans)
    idle: dict[str, float] = {}
    for a, b in idle_gaps(profile.device, profile.t0, profile.t1):
        k = label(0.5 * (a + b))
        idle[k] = idle.get(k, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
