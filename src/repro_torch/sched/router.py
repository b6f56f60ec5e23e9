"""``RequestRouter`` — the placement brain between submit() and workers.

The router owns the request backlog and, per request, chooses a
(prefill, decode) pair through a pluggable policy:

  * candidates come from ``ClusterScheduler`` membership, annotated with
    the ``LoadReport`` piggybacked on each worker's heartbeat;
  * decode candidates additionally carry the modeled cost of pulling
    THIS request's KV footprint over the (prefill, decode) link — the
    topology map ``links[(pwid, dwid)]`` holds per-pair ``LinkModel``s
    (rail-aligned NICs, cross-pod DCN hops, ...), defaulting to one
    uniform link;
  * a small projected-busy ledger per prefill worker lets the router
    estimate queue wait, and therefore TTFT = wait + prefill + transfer,
    without a second control round-trip;
  * the policy's ``admit`` vote turns that projection into admission
    control — rejected requests either raise ``AdmissionRejected`` or
    join the backlog for ``drain_backlog`` to retry when load falls.

Failure handling: ``on_worker_failed`` drops the dead worker's ledger
entry; the serving layer re-submits in-flight requests through
``route()`` again, which can only pick live members (the scheduler has
already removed the dead worker).

Copy of ``src/repro/sched/router.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterable

from repro_torch.core.cluster import ClusterScheduler
from repro_torch.core.transfer_engine import LinkModel
from repro_torch.sched.load import LoadReport, modeled_transfer_s
from repro_torch.sched.policies import Candidate, Policy, RouteRequest, make_policy

__all__ = ["RequestRouter", "RouteDecision", "AdmissionRejected", "NoWorkersError"]


class NoWorkersError(RuntimeError):
    """No live worker of a required role — nothing to route to."""


class AdmissionRejected(RuntimeError):
    """SLO admission control rejected the request: its projected TTFT
    already exceeds the deadline of its class."""

    def __init__(self, request_id: str, projected_ttft_s: float, deadline_s: float) -> None:
        super().__init__(
            f"{request_id}: projected TTFT {projected_ttft_s:.3f}s exceeds "
            f"SLO deadline {deadline_s:.3f}s"
        )
        self.request_id = request_id
        self.projected_ttft_s = projected_ttft_s
        self.deadline_s = deadline_s


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    request_id: str
    prefill_worker: str
    decode_worker: str
    projected_ttft_s: float
    transfer_cost_s: float


def _default_prefill_time(prompt_len: int) -> float:
    # Generic linear prefill estimate (~50k tok/s) used when the caller
    # has no calibrated CostModel; only relative projections matter for
    # placement, absolute ones for SLO admission (callers with real SLOs
    # pass a calibrated fn).
    return prompt_len / 50_000.0


class RequestRouter:
    def __init__(
        self,
        scheduler: ClusterScheduler,
        policy: str | Policy = "least_loaded",
        *,
        links: dict[tuple[str, str], LinkModel] | None = None,
        default_link: LinkModel | None = None,
        prefill_time_fn: Callable[[int], float] | None = None,
        coalesce_factor: float = 8.0,
        span_bytes: int = 64 * 1024,
        metrics=None,
        stale_after_s: float | None = None,
        **policy_kwargs,
    ) -> None:
        self.scheduler = scheduler
        # LoadReport staleness guard: a report older than this (relative
        # to the routing call's ``now``) is distrusted — the worker is
        # scored as fully loaded and excluded from capacity fits, so the
        # router stops placing work on a silently-dead or wedged worker
        # before liveness reaping catches it.  None derives the cutoff
        # from the scheduler's heartbeat timeout (a small multiple: one
        # missed heartbeat is jitter, several is a signal).
        self.stale_after_s = stale_after_s
        # Draining workers (fleet scale-down): still alive, still serving
        # what they hold, but no NEW placements — candidates skip them
        # unless literally nobody else is left.
        self.draining: set[str] = set()
        # optional repro_torch.obs.MetricsRegistry: routing decisions and hedge
        # outcomes land here when the serving layer wires one in
        self.metrics = metrics
        self.policy = make_policy(policy, **policy_kwargs)
        self.links = dict(links or {})
        self.default_link = default_link or LinkModel()
        self.prefill_time_fn = prefill_time_fn or _default_prefill_time
        self.coalesce_factor = coalesce_factor
        self.span_bytes = span_bytes

        self._busy_until: dict[str, float] = {}  # projected prefill completion
        self._charges: dict[str, tuple[str, float]] = {}  # rid -> (worker, t_prefill)
        self.backlog: collections.deque[RouteRequest] = collections.deque()
        self.decisions: dict[str, RouteDecision] = {}
        self.total_transfer_cost_s = 0.0
        self.rejected_count = 0

    # ------------------------------------------------------------- links
    def link(self, prefill_worker: str, decode_worker: str) -> LinkModel:
        return self.links.get((prefill_worker, decode_worker), self.default_link)

    def _resident_blocks(self, ctx: RouteRequest, worker_id: str) -> int:
        """Whole blocks of this request's prefix the worker advertises as
        resident (``LoadReport.prefix_blocks``), capped at the request's
        own footprint — the blocks a delta plan would graft instead of
        pull."""
        if ctx.prefix_id is None:
            return 0
        rep: LoadReport | None = self.scheduler.load(worker_id)
        if rep is None:
            return 0
        total = -(-ctx.prompt_len // max(rep.block_size, 1))
        return min(rep.resident_blocks_for(ctx.prefix_id), total)

    def transfer_cost_s(self, ctx: RouteRequest, prefill_worker: str,
                        decode_worker: str) -> float:
        """Modeled pull cost, delta-aware: when the decode worker
        advertises part of this request's prefix as resident, only the
        suffix bytes move — the router prices exactly what the decode
        worker's delta plan will put on the wire, so prefix-affinity
        placement and network-aware placement agree on the savings."""
        kv_bytes = ctx.kv_bytes
        resident = self._resident_blocks(ctx, decode_worker)
        if resident:
            rep = self.scheduler.load(decode_worker)
            total = -(-ctx.prompt_len // max(rep.block_size, 1))
            kv_bytes = kv_bytes * (total - resident) // total
        return modeled_transfer_s(
            kv_bytes,
            self.link(prefill_worker, decode_worker),
            span_bytes=self.span_bytes,
            coalesce_factor=self.coalesce_factor,
        )

    # -------------------------------------------------------- candidates
    def _stale_cutoff_s(self) -> float:
        if self.stale_after_s is not None:
            return self.stale_after_s
        # 2.5 heartbeats: one missed beat is jitter, several a signal
        return 2.5 * getattr(self.scheduler, "heartbeat_timeout_s", 5.0)

    def _is_stale(self, rep: LoadReport | None, now: float | None) -> bool:
        if rep is None or now is None:
            return False
        return now - rep.t > self._stale_cutoff_s()

    def _candidate(self, worker_id: str, *, ready_s: float = 0.0,
                   transfer_cost_s: float = 0.0,
                   prefix_hit: float = 0.0,
                   now: float | None = None) -> Candidate:
        rep: LoadReport | None = self.scheduler.load(worker_id)
        if rep is None:
            return Candidate(worker_id, ready_s=ready_s,
                             transfer_cost_s=transfer_cost_s,
                             prefix_hit=prefix_hit)
        if self._is_stale(rep, now):
            # A frozen report must not make the worker look attractive —
            # its blocks may be full (or the worker dead).  Score it as
            # fully loaded so every load-sensitive policy avoids it;
            # _has_room excludes it from capacity fits the same way.
            return Candidate(
                worker_id,
                free_units=0,
                total_units=rep.total_blocks,
                queued_units=rep.total_blocks,
                resident=rep.resident_requests,
                ready_s=ready_s,
                transfer_cost_s=transfer_cost_s,
                prefix_hit=prefix_hit,
            )
        return Candidate(
            worker_id,
            free_units=rep.free_blocks,
            total_units=rep.total_blocks,
            queued_units=rep.queued_blocks,
            resident=rep.resident_requests,
            ready_s=ready_s,
            transfer_cost_s=transfer_cost_s,
            prefix_hit=prefix_hit,
        )

    def _prefix_hit(self, ctx: RouteRequest, worker_id: str) -> float:
        """1.0 iff the worker's latest LoadReport says the request's
        shared prefix is resident there (prefix-affinity routing)."""
        if ctx.prefix_id is None:
            return 0.0
        rep: LoadReport | None = self.scheduler.load(worker_id)
        if rep is None:
            return 0.0
        return 1.0 if ctx.prefix_id in rep.prefix_ids else 0.0

    def _routable(self, role: str) -> list:
        """Live members minus draining workers — unless draining is all
        that's left (better to place than to wedge every request)."""
        members = self.scheduler.workers(role)
        open_ = [w for w in members if w.worker_id not in self.draining]
        return open_ or members

    def prefill_candidates(self, now: float = 0.0) -> list[Candidate]:
        return [
            self._candidate(
                w.worker_id,
                ready_s=max(0.0, self._busy_until.get(w.worker_id, 0.0) - now),
                now=now,
            )
            for w in self._routable("prefill")
        ]

    def decode_candidates(self, ctx: RouteRequest, prefill_worker: str,
                          *, now: float | None = None) -> list[Candidate]:
        return [
            self._candidate(
                w.worker_id,
                transfer_cost_s=self.transfer_cost_s(ctx, prefill_worker, w.worker_id),
                prefix_hit=self._prefix_hit(ctx, w.worker_id),
                now=now,
            )
            for w in self._routable("decode")
        ]

    def _has_room(self, ctx: RouteRequest, worker_id: str,
                  now: float | None = None) -> bool:
        rep: LoadReport | None = self.scheduler.load(worker_id)
        if rep is None:
            return True  # no telemetry yet: assume room
        if self._is_stale(rep, now):
            return False  # frozen occupancy can't vouch for capacity
        needed = -(-ctx.prompt_len // max(rep.block_size, 1))
        # resident prefix blocks are grafted (shared), not allocated:
        # only the suffix draws on the worker's free/evictable budget
        needed -= min(rep.resident_blocks_for(ctx.prefix_id), needed)
        return rep.free_blocks + rep.evictable_blocks >= needed

    def _fitting(self, ctx: RouteRequest, cands: list[Candidate],
                 now: float | None = None) -> list[Candidate]:
        """Only offer candidates that can hold the request's KV right
        now — a cost-first policy (network_aware) must not pin requests
        to a full worker while another has room.  Falls back to the full
        list when nobody fits (the request queues rather than erroring)."""
        fitting = [c for c in cands if self._has_room(ctx, c.worker_id, now)]
        return fitting or cands

    # ------------------------------------------------------------- route
    def route(self, ctx: RouteRequest, *, now: float = 0.0,
              queue_on_reject: bool = False, force: bool = False,
              count_reject: bool = True) -> RouteDecision | None:
        """Place ``ctx`` on a (prefill, decode) pair.

        Raises ``NoWorkersError`` if a role has no live members and
        ``AdmissionRejected`` if the policy's admission vote fails —
        unless ``queue_on_reject``, which parks the request in the
        backlog and returns None (retry via ``drain_backlog``), or
        ``force``, which skips the admission vote entirely (failover
        re-routing of an already-admitted request).
        """
        pcands = self.prefill_candidates(now)
        if not pcands:
            raise NoWorkersError("no live prefill workers")
        p = self.policy.pick_prefill(ctx, self._fitting(ctx, pcands, now))

        dcands = self.decode_candidates(ctx, p.worker_id, now=now)
        if not dcands:
            raise NoWorkersError("no live decode workers")
        d = self.policy.pick_decode(ctx, self._fitting(ctx, dcands, now))

        t_prefill = self.prefill_time_fn(ctx.prompt_len)
        # Projected TTFT follows the paper's definition (§5.1: TTFT
        # "includes the waiting time for the KV cache"), so the transfer
        # term belongs here.  The simulator's own projection omits it
        # because its measured first token is emitted at prefill
        # completion — each estimator targets the metric its surface
        # actually reports.
        projected = p.ready_s + t_prefill + d.transfer_cost_s
        if not force and not self.policy.admit(ctx, projected):
            if count_reject:
                self.rejected_count += 1
            if self.metrics is not None:
                self.metrics.inc("router.rejected")
            if queue_on_reject:
                self.backlog.append(ctx)
                return None
            deadline = getattr(self.policy, "deadline_s", lambda _: float("inf"))(ctx)
            raise AdmissionRejected(ctx.request_id, projected, deadline)

        self._busy_until[p.worker_id] = now + p.ready_s + t_prefill
        self._charges[ctx.request_id] = (p.worker_id, t_prefill)
        decision = RouteDecision(
            ctx.request_id, p.worker_id, d.worker_id, projected, d.transfer_cost_s
        )
        self.decisions[ctx.request_id] = decision
        self.total_transfer_cost_s += d.transfer_cost_s
        if self.metrics is not None:
            self.metrics.inc("router.routed")
            self.metrics.observe("router.projected_ttft_s", projected)
            self.metrics.observe("router.transfer_cost_s", d.transfer_cost_s)
        return decision

    def pick_hedge_prefill(self, ctx: RouteRequest, exclude: set[str],
                           *, now: float = 0.0) -> str | None:
        """Hedged dispatch: choose a SECOND prefill worker (distinct from
        ``exclude``, normally the primary) to run a duplicate prefill of
        ``ctx``.  Returns None when no alternative worker is alive —
        hedging silently degrades to a single dispatch.  The twin's work
        is charged to the ledger under a hedge id so TTFT projections see
        it; ``forget(request_id)`` retires both charges."""
        cands = [c for c in self.prefill_candidates(now)
                 if c.worker_id not in exclude]
        if not cands:
            if self.metrics is not None:
                self.metrics.inc("router.hedge_unavailable")
            return None
        p = self.policy.pick_prefill(ctx, self._fitting(ctx, cands, now))
        t_prefill = self.prefill_time_fn(ctx.prompt_len)
        self._busy_until[p.worker_id] = now + p.ready_s + t_prefill
        self._charges[f"{ctx.request_id}#hedge"] = (p.worker_id, t_prefill)
        if self.metrics is not None:
            self.metrics.inc("router.hedge_picked")
        return p.worker_id

    def forget_hedge(self, request_id: str) -> None:
        """Retire only the hedge charge — the twin never ran (its pool
        was full), so its projected work must not skew placement."""
        charge = self._charges.pop(f"{request_id}#hedge", None)
        if charge is not None:
            wid, t_prefill = charge
            if wid in self._busy_until:
                self._busy_until[wid] -= t_prefill

    def drain_backlog(self, *, now: float = 0.0) -> list[RouteDecision]:
        """Retry queued requests in FIFO order; stops at the first that
        is still rejected (later arrivals must not starve it).  Retries
        don't re-count toward ``rejected_count``."""
        routed: list[RouteDecision] = []
        while self.backlog:
            ctx = self.backlog.popleft()
            try:
                decision = self.route(ctx, now=now, count_reject=False)
            except (AdmissionRejected, NoWorkersError):
                self.backlog.appendleft(ctx)  # still blocked: keep FIFO head
                break
            routed.append(decision)
        return routed

    # --------------------------------------------------------- admission
    def plan_admissions(
        self,
        queued: Iterable[tuple[RouteRequest, str]],
        *,
        max_batch: int | None = None,
    ) -> dict[str, list[str]]:
        """Batch KV_QUEUED admissions per decode worker.

        ``queued`` is (request, assigned decode worker) for every request
        whose prefill KV is ready to pull.  Instead of the serving layer
        admitting them one call at a time, the router hands back one batch
        per worker — FIFO by arrival, capped by the worker's reported free
        blocks (each batch is admissible as a whole, so the decode worker
        can submit every pull before any byte moves and let the transfers
        pipeline behind decode compute) and optionally by ``max_batch``
        (None or 0 = uncapped, matching ``SimConfig.admission_batch``).
        A worker's batch is strictly head-of-line: when its oldest queued
        request doesn't fit the remaining budget, the worker admits
        nothing behind it — admitting younger, smaller requests around it
        would starve it indefinitely under a steady small-request stream
        (the same FIFO-fairness contract as ``DecodeWorker.admit_batch``).
        The one exception is a request larger than the worker's TOTAL
        capacity: it can never fit there, so it is skipped rather than
        wedging the worker forever.  Requests that don't fit stay
        KV_QUEUED for the next planning round; their prefill-side KV
        stays alive meanwhile (§4.3)."""
        max_batch = max_batch or None  # 0 means uncapped, like the sim knob
        batches: dict[str, list[str]] = {}
        budget: dict[str, float] = {}
        reports: dict[str, LoadReport | None] = {}  # one snapshot per worker
        closed: set[str] = set()  # head-of-line blocked this round
        # Stable sort on arrival only: ties keep the caller's submission
        # order (a request_id tie-break would sort "r10" before "r2").
        for ctx, wid in sorted(queued, key=lambda q: q[0].arrival_s):
            if wid in closed:
                continue
            if wid not in reports:
                reports[wid] = self.scheduler.load(wid)
                rep = reports[wid]
                # retained-prefix blocks are spendable: the worker evicts
                # its retention cache before failing an admission
                budget[wid] = float("inf") if rep is None else float(
                    rep.free_blocks + rep.evictable_blocks)
            rep = reports[wid]
            batch = batches.setdefault(wid, [])
            if max_batch is not None and len(batch) >= max_batch:
                closed.add(wid)
                continue
            needed = -(-ctx.prompt_len // max(rep.block_size, 1)) if rep else 0
            if rep is not None:
                # delta admission: the resident prefix grafts for free,
                # so only the suffix charges against the worker's budget
                needed -= min(rep.resident_blocks_for(ctx.prefix_id), needed)
            if rep is not None and needed > rep.total_blocks:
                continue  # can NEVER fit this worker: don't wedge its queue
            if budget[wid] < needed:
                closed.add(wid)  # head of line waits; nobody jumps it
                continue
            budget[wid] -= needed
            batch.append(ctx.request_id)
        return {wid: rids for wid, rids in batches.items() if rids}

    # ---------------------------------------------------------- failover
    def reassign_decode(self, ctx: RouteRequest, prefill_worker: str,
                        *, now: float | None = None) -> str:
        """Re-pick only the decode side for an already-routed request
        (decode failover while its prefill KV is still alive).  Keeps the
        recorded decision and transfer-cost accounting consistent."""
        cands = self.decode_candidates(ctx, prefill_worker, now=now)
        if not cands:
            raise NoWorkersError("no live decode workers")
        d = self.policy.pick_decode(ctx, self._fitting(ctx, cands, now))
        old = self.decisions.get(ctx.request_id)
        if old is not None:
            self.total_transfer_cost_s += d.transfer_cost_s - old.transfer_cost_s
            self.decisions[ctx.request_id] = dataclasses.replace(
                old, decode_worker=d.worker_id, transfer_cost_s=d.transfer_cost_s)
        return d.worker_id

    def on_worker_failed(self, worker_id: str) -> None:
        self._busy_until.pop(worker_id, None)
        self.draining.discard(worker_id)

    # ---------------------------------------------------------- draining
    def mark_draining(self, worker_id: str) -> None:
        """Fleet scale-down: stop offering ``worker_id`` for new
        placements while it drains what it already holds."""
        self.draining.add(worker_id)

    def clear_draining(self, worker_id: str) -> None:
        self.draining.discard(worker_id)

    def forget(self, request_id: str) -> None:
        """Drop a request's decision AND retire its ledger charge, so a
        completed (or abandoned) prefill stops counting against future
        admission projections."""
        self.decisions.pop(request_id, None)
        for rid in (request_id, f"{request_id}#hedge"):
            charge = self._charges.pop(rid, None)
            if charge is not None:
                wid, t_prefill = charge
                if wid in self._busy_until:
                    self._busy_until[wid] -= t_prefill

    # ------------------------------------------------------------- stats
    def requeue(self, ctx: RouteRequest) -> None:
        """Put a failed in-flight request back at the head of the line."""
        self.backlog.appendleft(ctx)

    def summary(self) -> dict[str, float]:
        return {
            "routed": float(len(self.decisions)),
            "rejected": float(self.rejected_count),
            "backlog": float(len(self.backlog)),
            "total_transfer_cost_s": self.total_transfer_cost_s,
        }
