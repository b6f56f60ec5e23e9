"""Cluster scheduler — dynamic worker membership (§4.2).

Message-passing collectives (NCCL/MPI) freeze the communication graph at
init; adding a GPU means restarting the service (paper Motivation #2).
KVDirect instead keeps a tiny control-plane registry: workers join and
leave a *running* cluster, the scheduler broadcasts membership changes,
and decode workers react by CONNECTing to new prefill workers.

The scheduler is control-plane only.  Descriptors and reads flow directly
between workers, so a scheduler outage stalls membership changes but not
inference (tested in tests/test_cluster.py).

Failure handling built on the same path:
  * ``remove_worker(id, failed=True)`` — crash: decode workers invalidate
    the connection epoch; the serving layer re-queues in-flight requests.
  * heartbeats with a deadline drive crash detection;
  * stragglers are the serving scheduler's job (hedged prefill dispatch),
    built on the membership info here.

Copy of ``src/repro/core/cluster.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from repro_torch.core.connection import WorkerInfo

__all__ = ["ClusterScheduler", "MembershipEvent"]


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    kind: str  # "added" | "removed" | "failed"
    worker: WorkerInfo


class ClusterScheduler:
    def __init__(self, *, heartbeat_timeout_s: float = 5.0) -> None:
        self._workers: dict[str, WorkerInfo] = {}
        self._subs: list[Callable[[MembershipEvent], None]] = []
        self._last_heartbeat: dict[str, float] = {}
        self._loads: dict[str, object] = {}  # latest LoadReport per worker
        self.heartbeat_timeout_s = heartbeat_timeout_s

    # -------------------------------------------------------- membership
    def add_worker(self, info: WorkerInfo, *, now: float = 0.0) -> None:
        if info.worker_id in self._workers:
            raise ValueError(f"worker {info.worker_id!r} already in cluster")
        self._workers[info.worker_id] = info
        self._last_heartbeat[info.worker_id] = now
        self._broadcast(MembershipEvent("added", info))

    def remove_worker(self, worker_id: str, *, failed: bool = False) -> None:
        info = self._workers.pop(worker_id, None)
        if info is None:
            return
        self._last_heartbeat.pop(worker_id, None)
        self._loads.pop(worker_id, None)
        self._broadcast(MembershipEvent("failed" if failed else "removed", info))

    # --------------------------------------------------------- liveness
    def heartbeat(self, worker_id: str, now: float, load: object | None = None) -> None:
        """Liveness ping, optionally piggybacking a ``sched.LoadReport``
        so the router sees per-worker occupancy without a second control
        channel (the scheduler stores it opaquely)."""
        if worker_id in self._workers:
            self._last_heartbeat[worker_id] = max(self._last_heartbeat[worker_id], now)
            if load is not None:
                self._loads[worker_id] = load

    def report_load(self, worker_id: str, load: object) -> None:
        """Store a LoadReport WITHOUT refreshing liveness — for control
        planes that read worker state directly (a colocated serving
        layer); liveness stays owned by the workers' own heartbeats."""
        if worker_id in self._workers:
            self._loads[worker_id] = load

    def reap_dead(self, now: float) -> list[str]:
        """Crash detection: drop workers whose heartbeat lapsed.

        ALL lapsed workers leave membership before any failure event is
        broadcast — subscribers re-route in-flight work synchronously on
        the event, and must never be offered a worker that is dead but
        not yet reaped in the same sweep."""
        dead = [
            w
            for w, t in self._last_heartbeat.items()
            if now - t > self.heartbeat_timeout_s
        ]
        infos = []
        for w in dead:
            info = self._workers.pop(w, None)
            self._last_heartbeat.pop(w, None)
            self._loads.pop(w, None)
            if info is not None:
                infos.append(info)
        for info in infos:
            self._broadcast(MembershipEvent("failed", info))
        return dead

    # ------------------------------------------------------------ query
    def workers(self, role: str | None = None) -> list[WorkerInfo]:
        ws: Iterable[WorkerInfo] = self._workers.values()
        if role is not None:
            ws = (w for w in ws if w.role == role)
        return sorted(ws, key=lambda w: w.worker_id)

    def get(self, worker_id: str) -> WorkerInfo:
        return self._workers[worker_id]

    def load(self, worker_id: str):
        """Latest heartbeat-piggybacked LoadReport (None if never sent)."""
        return self._loads.get(worker_id)

    def loads(self, role: str | None = None) -> dict[str, object]:
        return {
            w.worker_id: self._loads[w.worker_id]
            for w in self.workers(role)
            if w.worker_id in self._loads
        }

    def __contains__(self, worker_id: str) -> bool:
        return worker_id in self._workers

    # -------------------------------------------------------- broadcast
    def subscribe(self, cb: Callable[[MembershipEvent], None]) -> None:
        self._subs.append(cb)

    def _broadcast(self, ev: MembershipEvent) -> None:
        for cb in list(self._subs):
            cb(ev)
