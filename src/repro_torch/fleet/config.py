"""Fleet control-plane configuration.

One frozen config covers the three cooperating pieces of ``repro_torch.fleet``
(docs/fleet.md): the autoscaler's thresholds and bounds, the memory-
pressure preemption mode and victim policy, and the admission-control
budget.  Everything defaults OFF — a ``DisaggService`` without a
``FleetConfig`` behaves exactly as before.

Copy of ``src/repro/fleet/config.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

__all__ = ["FleetConfig"]

# Victim ranking for victim_policy="priority": higher rank = preempted
# first.  Matches the SLO classes sched.policies ships by default.
DEFAULT_CLASS_RANK = {"interactive": 0, "standard": 1, "batch": 2}


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    # ---------------------------------------------------------- autoscaler
    autoscale: bool = False
    min_prefill: int = 1
    max_prefill: int = 4
    min_decode: int = 1
    max_decode: int = 4
    # Equal-peak-hardware mode (P/D-Serve's dynamic ratio adjustment):
    # when set, prefill + decode never exceeds this total — growing one
    # role drains the other, shifting the P/D split instead of adding
    # hardware.  None = roles grow independently up to their maxima.
    total_cap: int | None = None
    # Pressure thresholds (see Autoscaler for the signals): grow a role
    # when its pressure stays above scale_up for `patience` consecutive
    # evaluations; drain its least-loaded worker when pressure stays
    # below scale_down (and the role is above its minimum).
    scale_up: float = 0.85
    scale_down: float = 0.25
    patience: int = 2
    # KV pool size for hot-added workers (blocks).
    worker_blocks: int = 256

    # ------------------------------------------------------- preemption
    # "none" — a full decode pool parks/queues (the pre-fleet behavior);
    # "swap" — copy the victim's KV pages to the host pool, restore on
    #          resume (token stream pauses, never truncates);
    # "sacrifice" — drop the victim's decode KV and replay it through
    #          PR 5's truncate-and-replay (cheaper than swap for short
    #          contexts, re-pulls the KV on replay).
    preempt: str = "none"
    # Victim selection among residents: "lifo" (newest first — protects
    # long-running work), "fifo" (oldest first — protects fresh
    # arrivals), "priority" (lowest-priority SLO class first).
    victim_policy: str = "lifo"
    # Occupancy watermark: preemption only fires while the worker's pool
    # is at least this full AND a queued request can't be admitted.
    # Lower = aggressive (preempts early), higher = conservative.
    preempt_high: float = 0.92
    # Host swap pool byte budget (None = unbounded).  A swap that would
    # exceed it is refused and the waiter keeps queueing (park behavior).
    swap_pool_bytes: int | None = None
    # A request is preempted at most this many times — an oscillating
    # governor (victim re-admits, gets preempted again, ...) must
    # terminate at park behavior rather than livelock.
    max_preemptions: int = 2

    # -------------------------------------------------------- admission
    # Reject/defer dispatch when the decode fleet's projected KV
    # occupancy (in-use + queued + this request) exceeds this fraction.
    # None disables admission control.
    admission_budget: float | None = None
    # "reject" — typed KVBudgetExceeded surfaces on the handle (FAILED);
    # "defer" — the request stays QUEUED_PREFILL for a later tick.
    admission_mode: str = "reject"

    def __post_init__(self) -> None:
        if self.preempt not in ("none", "swap", "sacrifice"):
            raise ValueError(
                f"preempt must be none|swap|sacrifice, got {self.preempt!r}")
        if self.victim_policy not in ("lifo", "fifo", "priority"):
            raise ValueError(
                f"victim_policy must be lifo|fifo|priority, got "
                f"{self.victim_policy!r}")
        if self.admission_mode not in ("reject", "defer"):
            raise ValueError(
                f"admission_mode must be reject|defer, got "
                f"{self.admission_mode!r}")
