"""``ServeLoop`` — the event-driven heart of the streaming serving API.

One ``tick()`` advances EVERY live request one notch through the
pipeline, interleaving the four kinds of work a disaggregated serving
node juggles:

  1. **prefill dispatch** — queued submissions (``dispatch="queued"``)
     are routed and prefilled; SLO admission rejections surface on the
     handle as FAILED instead of raising at the caller;
  2. **retirement** — requests whose stream completed (budget/EOS on
     the previous step, EOS straight from prefill, or finished through
     the legacy direct-worker path) leave before anything else runs;
  3. **admission planning** — the router batches every KV_QUEUED request
     per decode worker (capacity-capped, FIFO) and the pulls are
     SUBMITTED, not drained;
  4. **transfer progress** — the engine's per-tick budget hook
     (``TransferEngine.tick``) advances queued transactions, but only
     when no decode worker has compute to hide them behind — otherwise
     the workers' own between-step pumps do the hiding;
  5. **per-step decode** — each decode worker runs ONE continuous-
     batching ``step()``: requests join the running batch the moment
     their KV lands (or stream it in layer-by-layer), produce one token
     each, and leave at EOS / ``max_new`` without stalling cohabitants.

``run_until_idle()`` ticks until every driven handle is DONE (or parked
by failover), with the same stall detection the old round-synchronous
``generate_many`` had: if a full tick makes no progress of any kind and
no request moved (failover counts as movement), ``ServeLoopStalled``
raises naming the stuck requests.

The loop is deliberately synchronous and deterministic — one tick is one
pass, tokens are appended to handles as steps land — which is what lets
``generate``/``generate_many`` remain thin, token-identical shims on
top of it.

Copy of ``src/repro/serving/loop.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import collections
import dataclasses
import time

from repro_torch.fleet.admission import AdmissionDeferred
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sched import AdmissionRejected, NoWorkersError
from repro_torch.serving.blocks import OutOfBlocks
from repro_torch.serving.request import RequestState

__all__ = ["ServeLoop", "ServeLoopStalled", "TickReport"]


class ServeLoopStalled(RuntimeError):
    """No request can make progress: typically every stuck request's
    decode pool is too small for its KV footprint.

    Stall forensics: the exception carries the FINAL ``TickReport``
    (``report``) and the loop's cumulative per-phase progress counters
    (``phase_counters``), and renders both into the message — so a CI
    log alone shows *which* pipeline phase stopped moving (nothing ever
    admitted?  tokens flowed then stopped?  engine still churning?)."""

    def __init__(self, request_ids, report: "TickReport | None" = None,
                 phase_counters: dict | None = None) -> None:
        self.request_ids = tuple(sorted(request_ids))
        self.report = report
        self.phase_counters = dict(phase_counters or {})
        stuck = ", ".join(self.request_ids)
        msg = (f"serve loop stalled: {stuck} cannot make progress "
               "(decode pools too small for the request?)")
        if report is not None:
            msg += f"\n  last tick: {report.describe()}"
        if self.phase_counters:
            totals = ", ".join(f"{k}={int(v)}"
                               for k, v in sorted(self.phase_counters.items()))
            msg += f"\n  phase totals: {totals}"
        super().__init__(msg)


@dataclasses.dataclass
class TickReport:
    """What one tick did — the loop's observable progress."""

    now: float
    dispatched: list[str] = dataclasses.field(default_factory=list)
    rejected: list[str] = dataclasses.field(default_factory=list)
    admitted: list[str] = dataclasses.field(default_factory=list)
    promoted: list[str] = dataclasses.field(default_factory=list)
    tokens: dict[str, int] = dataclasses.field(default_factory=dict)
    finished: list[str] = dataclasses.field(default_factory=list)
    engine_processed: int = 0
    # requests auto-revived from a failover park this tick
    revived: list[str] = dataclasses.field(default_factory=list)
    # fleet control-plane action counts (FleetController.step): nonzero
    # entries like {"swapped_out": 1, "added": 1, "retired": 1}
    fleet: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def progressed(self) -> bool:
        return bool(self.dispatched or self.rejected or self.admitted
                    or self.promoted or self.tokens or self.finished
                    or self.engine_processed or self.revived or self.fleet)

    def describe(self) -> str:
        """Every field on one line — what ServeLoopStalled embeds."""
        return (f"now={self.now:.6f} dispatched={self.dispatched} "
                f"rejected={self.rejected} admitted={self.admitted} "
                f"promoted={self.promoted} tokens={self.tokens} "
                f"finished={self.finished} "
                f"engine_processed={self.engine_processed} "
                f"revived={self.revived} fleet={self.fleet}")


class ServeLoop:
    def __init__(self, service, *, pump_budget: int | None = 32,
                 engine_budget: int | None = None,
                 max_admit: int | None = None) -> None:
        self.service = service
        self.pump_budget = pump_budget      # worker between-step pumps
        # per-tick transfer budget; None mirrors pump_budget so transfer
        # work stays metered at the same grain as the between-step pumps
        # (a free-running engine would drain whole pulls before the first
        # decode step could hide them)
        self.engine_budget = engine_budget
        self.max_admit = max_admit          # per-worker admission cap
        self.ticks = 0
        # Stall forensics (see ServeLoopStalled): the most recent tick's
        # report plus cumulative per-phase progress totals.
        self.last_report: TickReport | None = None
        self.phase_counters: collections.Counter[str] = collections.Counter()
        # (n_prefill, n_decode) at the end of the last tick — parked
        # requests auto-revive when this changes (capacity returned)
        self._fleet_size: tuple[int, int] | None = None

    # ------------------------------------------------------------- tick
    def tick(self, now: float | None = None) -> TickReport:
        """One pass over the pipeline; returns what moved."""
        svc = self.service
        if now is not None:
            svc.clock = max(svc.clock, now)
        self.ticks += 1
        report = TickReport(now=svc.clock)
        tracer = getattr(svc, "tracer", NULL_TRACER)
        clock = getattr(svc, "obs_clock", time.monotonic)
        tick_span = tracer.span("tick", track="loop", tick=self.ticks)

        # Snapshot the dispatch backlog BEFORE step 1 drains it: the
        # autoscaler's prefill-pressure signal (docs/fleet.md) must see
        # the queue depth arrivals produced, not the post-dispatch zero.
        backlog = sum(1 for req, _ in svc.pending.values()
                      if req.state is RequestState.QUEUED_PREFILL)

        # 1. dispatch queued submissions (prefill + routing)
        with tracer.span("tick.dispatch", track="loop"):
            for rid, h in list(svc.handles.items()):
                if h.request.state is not RequestState.QUEUED_PREFILL:
                    continue
                entry = svc.pending.get(rid)
                if entry is None:
                    continue
                try:
                    svc._dispatch(h.request, entry[1], hedge=h.hedge)
                    report.dispatched.append(rid)
                except AdmissionDeferred:
                    pass  # soft verdict: stays QUEUED, retried next tick
                except AdmissionRejected as e:
                    svc._reject_queued(rid, e)
                    report.rejected.append(rid)
                except (NoWorkersError, OutOfBlocks):
                    pass  # stays QUEUED; capacity may come back next tick

        # 2. retire finished requests BEFORE admission and decode: a
        # request whose stream is already complete (EOS/budget reached
        # on the previous tick's step, EOS straight from prefill, or a
        # zero budget) must not be admitted or stepped again.  DECODING
        # is the normal exit; KV_QUEUED means no pull ever started (the
        # prefill copy is released by _finish_request); a handle already
        # DONE (finished through the legacy direct-worker path) is swept
        # so it can't wedge run_until_idle.
        with tracer.span("tick.retire", track="loop"):
            for rid, h in list(svc.handles.items()):
                st = h.request.state
                if st is RequestState.DONE or (
                        st in (RequestState.DECODING, RequestState.KV_QUEUED)
                        and h.decode_finished()):
                    svc._finish_request(rid)
                    report.finished.append(rid)

        # 2½. fleet control plane (docs/fleet.md) — preemption governor,
        # autoscaler, drain advancement — BETWEEN retire and admit, so
        # capacity it frees (a swap-out, a retired drain, a hot-added
        # worker) is usable for admission in this same tick.
        if getattr(svc, "fleet", None) is not None:
            with tracer.span("tick.fleet", track="loop") as s:
                report.fleet = svc.fleet.step(dispatch_backlog=backlog)
                s.set(**report.fleet)

        # 2¾. auto-revive parked requests when capacity returned this
        # tick: the fleet changed size, a fleet action freed blocks, or
        # a request finished (its blocks are back in the pool).  A bare
        # retry every tick would inflate retry counters for nothing.
        fleet_size = (len(svc.prefills), len(svc.decodes))
        capacity_changed = (fleet_size != self._fleet_size
                            or bool(report.finished) or bool(report.fleet))
        self._fleet_size = fleet_size
        if capacity_changed and any(
                req.state is RequestState.FAILED
                for req, _ in svc.pending.values()):
            with tracer.span("tick.revive", track="loop"):
                report.revived = svc.retry_parked()

        # 3. router-planned admission batches (KV_QUEUED -> pulls queued)
        with tracer.span("tick.admit", track="loop"):
            admitted = svc.admit_queued(only=set(svc.handles),
                                        max_batch=self.max_admit)
            for rids in admitted.values():
                report.admitted.extend(rids)

        # 4. engine tick budget — run it when there is no decode compute
        # to hide the transfer behind, or when some full-consumption
        # worker's pulls would otherwise starve (it has nothing resident,
        # so it won't pump between steps).  In every other case the
        # workers' own between-step pumps advance the engine — that's
        # where the transfer/compute overlap comes from.
        no_compute = not any(dw.resident for dw in svc.decodes.values())
        starved = any(dw.inflight and not dw.resident and dw.consume == "full"
                      for dw in svc.decodes.values())
        if svc.engine.pending and (no_compute or starved):
            budget = self.engine_budget
            if budget is None:
                budget = self.pump_budget  # None again -> engine.tick_budget
            with tracer.span("tick.transfer", track="loop") as s:
                report.engine_processed = svc.engine.tick(budget)
                s.set(processed=report.engine_processed)

        # 5. promote pulls that resolved
        with tracer.span("tick.promote", track="loop"):
            report.promoted = svc.pump(0)

        # 6. one continuous-batching decode step per worker with work
        for dw in list(svc.decodes.values()):
            if not (dw.resident or (dw.consume == "layerwise" and dw.inflight)):
                continue
            with tracer.span("tick.step", track=("worker", dw.info.worker_id),
                             batch=len(dw.resident)) as s:
                out = dw.step(pump_budget=self.pump_budget)
                s.set(tokens=len(out))
            at = clock()
            for rid, tok in out.items():
                h = svc.handles.get(rid)
                if h is None:
                    continue
                h._push(tok, at)
                h.request.token_times_s.append(svc.clock)
                report.tokens[rid] = tok

        tick_span.end()
        self._account(report)
        return report

    def _account(self, report: TickReport) -> None:
        """Fold one tick's movement into the cumulative phase counters
        and the service metrics registry."""
        self.last_report = report
        pc = self.phase_counters
        pc["ticks"] += 1
        moved = {
            "dispatched": len(report.dispatched),
            "rejected": len(report.rejected),
            "admitted": len(report.admitted),
            "promoted": len(report.promoted),
            "tokens": len(report.tokens),
            "finished": len(report.finished),
            "engine_processed": report.engine_processed,
            "revived": len(report.revived),
        }
        for k, n in report.fleet.items():
            pc[f"fleet.{k}"] += n
        for k, n in moved.items():
            if n:
                pc[k] += n
        metrics = getattr(self.service, "metrics", None)
        if metrics is not None:
            metrics.inc("loop.ticks")
            for k, n in moved.items():
                if n:
                    metrics.inc(f"loop.{k}", n)
            metrics.set_gauge("loop.active_requests",
                              len(self.service.handles))

    # ------------------------------------------------------------ drive
    def _signature(self, rids) -> dict[str, tuple]:
        svc = self.service
        sig = {}
        for rid in rids:
            h = svc.handles.get(rid)
            if h is None:
                sig[rid] = ("gone",)
                continue
            r = h.request
            sig[rid] = (r.state, r.prefill_worker, r.decode_worker,
                        len(h.tokens))
        return sig

    def _active(self, only: set[str] | None) -> list[str]:
        """Handles still being driven: not DONE (a legacy direct-worker
        finish leaves a DONE handle registered until the next tick
        sweeps it), not parked."""
        return [rid for rid, h in self.service.handles.items()
                if (only is None or rid in only)
                and h.request.state not in (RequestState.FAILED,
                                            RequestState.DONE)]

    def run_until_idle(self, only: set[str] | None = None, *,
                       max_ticks: int = 100_000) -> list[str]:
        """Tick until every driven handle (all of them, or just ``only``)
        is DONE or parked.  Returns the request ids that finished DONE.
        Raises ``ServeLoopStalled`` when a tick moves nothing at all."""
        svc = self.service
        finished: list[str] = []
        for _ in range(max_ticks):
            active = self._active(only)
            if not active:
                return finished
            unbounded = [rid for rid in active
                         if svc.handles[rid].max_new is None
                         and svc.handles[rid].eos_token is None]
            if unbounded:
                raise ValueError(
                    f"run_until_idle would never terminate: {sorted(unbounded)} "
                    "have neither max_new nor eos_token — set a budget "
                    "(e.g. via generate_many) or drive tick() directly")
            before = self._signature(active)
            report = self.tick()
            finished.extend(report.finished)
            if report.progressed:
                continue
            if self._signature(active) != before:
                continue  # failover moved a request mid-tick: progress
            raise ServeLoopStalled(self._active(only), report=self.last_report,
                                   phase_counters=self.phase_counters)
        raise ServeLoopStalled(self._active(only), report=self.last_report,
                               phase_counters=self.phase_counters)

    def advance(self, handle, *, until_done: bool = False,
                max_ticks: int = 100_000) -> None:
        """Tick until ``handle`` produces at least one new token (or
        finishes); ``until_done`` keeps going to the end.  The streaming
        iterator's engine."""
        start = len(handle.tokens)
        for _ in range(max_ticks):
            if handle.finished or (not until_done
                                   and len(handle.tokens) > start):
                return
            active = self._active(None)
            before = self._signature(active)
            report = self.tick()
            if report.progressed or self._signature(active) != before:
                continue
            raise ServeLoopStalled([handle.request_id], report=self.last_report,
                                   phase_counters=self.phase_counters)
        raise ServeLoopStalled([handle.request_id], report=self.last_report,
                               phase_counters=self.phase_counters)
