"""``FleetController`` — the control plane above the router.

One controller per ``DisaggService`` (built when the service is given a
``FleetConfig``), stepped once per serving-loop tick between retirement
and admission — so capacity it frees (a resumed swap, a finished drain,
a hot-added worker) is usable for admission in the SAME tick.

It composes the three fleet pieces and owns the only mutable fleet
state, the drain ledger:

  * the ``MemoryGovernor`` (swap / sacrifice under KV pressure);
  * the ``Autoscaler`` (pure planner) — this controller APPLIES its
    actions through the paths that already exist: hot-add goes through
    ``DisaggService.add_*_worker`` (scheduler membership broadcast →
    connection tables), drain marks the worker in the router
    (``mark_draining``: no new routes) and reassigns its queued work,
    and retirement happens only once the worker is empty, via
    ``ClusterScheduler.remove_worker`` — the same graceful-leave event
    every other teardown uses.  A drained worker that dies mid-drain
    needs nothing special: hedged adoption and ``retry_parked`` already
    cover it, and the drain ledger entry is simply cleaned up;
  * the ``AdmissionController``, consulted by ``DisaggService._dispatch``
    (the controller just builds and exposes it).

Copy of ``src/repro/fleet/controller.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

from repro_torch.fleet.admission import AdmissionController
from repro_torch.fleet.autoscale import Autoscaler
from repro_torch.fleet.hostmem import HostSwapPool
from repro_torch.fleet.preempt import MemoryGovernor
from repro_torch.serving.request import RequestState

__all__ = ["FleetController"]


class FleetController:
    def __init__(self, service, cfg) -> None:
        self.service = service
        self.cfg = cfg
        m = service.metrics
        self.swap_pool = HostSwapPool(cfg.swap_pool_bytes)
        self.governor = (MemoryGovernor(cfg, self.swap_pool, metrics=m)
                         if cfg.preempt != "none" else None)
        self.autoscaler = Autoscaler(cfg, metrics=m) if cfg.autoscale else None
        self.admission = (AdmissionController(cfg.admission_budget,
                                              mode=cfg.admission_mode, metrics=m)
                          if cfg.admission_budget is not None else None)
        self.draining: dict[str, str] = {}  # worker_id -> role

    # --------------------------------------------------------------- step
    def step(self, now: float | None = None, *,
             dispatch_backlog: int | None = None) -> dict[str, int]:
        """One control-plane pass; returns nonzero action counts (the
        serving loop folds them into its ``TickReport.fleet``).

        ``dispatch_backlog`` is the QUEUED_PREFILL count snapshotted at
        tick start — the loop drains the queue before this step runs,
        so recounting here would always read zero.
        """
        svc = self.service
        if now is not None:
            svc.clock = max(svc.clock, now)
        svc._report_loads()
        counts: dict[str, int] = {}
        if self.governor is not None:
            for k, n in self.governor.step(
                    svc, draining=set(self.draining)).items():
                counts[k] = counts.get(k, 0) + n
        if self.autoscaler is not None:
            self._autoscale(counts, dispatch_backlog)
        self._advance_drains(counts)
        m = svc.metrics
        m.set_gauge("fleet.prefill_workers", len(svc.prefills))
        m.set_gauge("fleet.decode_workers", len(svc.decodes))
        m.set_gauge("fleet.draining", len(self.draining))
        m.set_gauge("fleet.swapped", len(self.swap_pool))
        return {k: n for k, n in counts.items() if n}

    # ---------------------------------------------------------- autoscale
    def _autoscale(self, counts: dict[str, int],
                   dispatch_backlog: int | None = None) -> None:
        svc = self.service
        p_reports = {wid: svc.scheduler.load(wid) for wid in svc.prefills}
        d_reports = {wid: svc.scheduler.load(wid) for wid in svc.decodes}
        backlog = dispatch_backlog
        if backlog is None:
            backlog = sum(1 for req, _ in svc.pending.values()
                          if req.state is RequestState.QUEUED_PREFILL)
        actions = self.autoscaler.plan(p_reports, d_reports,
                                       dispatch_backlog=backlog,
                                       draining=self.draining)
        for act in actions:
            if act[0] == "add":
                if self._add(act[1]) is not None:
                    counts["added"] = counts.get("added", 0) + 1
            else:  # ("drain", role, wid)
                self._drain(act[1], act[2])
                counts["draining"] = counts.get("draining", 0) + 1

    def _add(self, role: str) -> str | None:
        svc = self.service
        if svc.topology is not None and not svc.topology.has_spare(role):
            # topology-bound fleet: every machine in the ClusterSpec
            # already holds a role — there is nothing to hot-add onto.
            # Skip (with a metric) rather than conjure hardware.
            svc.metrics.inc("fleet.autoscale_no_spare")
            return None
        if role == "prefill":
            wid = svc.add_prefill_worker(num_blocks=self.cfg.worker_blocks)
        else:
            wid = svc.add_decode_worker(num_blocks=self.cfg.worker_blocks)
        svc.metrics.inc("fleet.workers_added")
        svc.tracer.instant("fleet.add", track="loop", worker=wid, role=role)
        return wid

    def _drain(self, role: str, wid: str) -> None:
        """Begin a drain: no NEW routes to the worker (router draining
        set), queued decode work moves to siblings; residents run to
        completion (or get swapped off by the governor) before
        ``_advance_drains`` retires it."""
        svc = self.service
        svc.router.mark_draining(wid)
        self.draining[wid] = role
        if role == "decode":
            svc.reassign_queued_off(wid)
        svc.metrics.inc("fleet.drains_started")
        svc.tracer.instant("fleet.drain", track="loop", worker=wid, role=role)

    # -------------------------------------------------------------- drain
    def _decode_busy(self, wid: str) -> bool:
        svc = self.service
        dw = svc.decodes.get(wid)
        if dw is None:
            return False  # died mid-drain: failover already moved its work
        if dw.resident or dw.inflight:
            return True
        # KV_QUEUED stragglers still assigned here (reassignment found no
        # room): the drain waits — retiring now would park them instead
        return any(req.decode_worker == wid
                   and req.state is RequestState.KV_QUEUED
                   for req, _ in svc.pending.values())

    def _prefill_busy(self, wid: str) -> bool:
        pw = self.service.prefills.get(wid)
        # in_use covers parked request KV awaiting pull AND live hedge
        # twins — both must leave before the slab (and its MR) goes away
        return pw is not None and pw.pool.stats.in_use > 0

    def _advance_drains(self, counts: dict[str, int]) -> None:
        svc = self.service
        for wid, role in list(self.draining.items()):
            alive = wid in (svc.decodes if role == "decode" else svc.prefills)
            busy = (self._decode_busy(wid) if role == "decode"
                    else self._prefill_busy(wid))
            if busy:
                continue
            if alive:
                # graceful leave: same membership event as any teardown
                svc.scheduler.remove_worker(wid)
                if svc.topology is not None:
                    svc.topology.release_worker(wid)  # machine -> spare pool
                svc.metrics.inc("fleet.workers_retired")
                svc.tracer.instant("fleet.retire", track="loop",
                                   worker=wid, role=role)
                counts["retired"] = counts.get("retired", 0) + 1
            svc.router.clear_draining(wid)
            del self.draining[wid]
