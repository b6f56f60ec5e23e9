"""End-to-end disaggregated serving — the paper's full pipeline on real
substrate: cluster scheduler + N prefill × M decode workers + KVDirect
engine + the ``repro_torch.sched`` request router.

Flow per request (pull-mode, §4.3):
  submit → router picks a (prefill, decode) pair via the configured
  policy (round-robin / least-loaded / network-aware / prefix-affinity /
  SLO admission) → model prefill (real compute) → KV blocks land in the
  prefill worker's registered slab → the ASSIGNED decode worker
  allocates + pulls via one-sided reads over its own connection table →
  COMPLETE frees the prefill copy → continuous-batching decode.

The front door is the STREAMING API (docs/serving.md): ``submit()``
returns a ``RequestHandle`` and the event-driven ``ServeLoop``
(``self.loop``) interleaves prefill dispatch, router-planned admission,
transfer progress, and per-step decode — requests join the running
batch as their KV lands and leave at EOS/max_new.  ``generate`` /
``generate_many`` survive as token-identical shims over the loop.
``submit(hedge=2)`` races twin prefills (first COMPLETE wins, the
loser's slab is freed, a dead primary's copy is adopted from the twin).

Topology: every decode worker owns a ``ConnectionManager`` with a live
connection to every prefill worker (§4.2's decode-side connection table),
so the router is free to pair any prefill with any decode.  Each worker's
KV slab gets a distinct, non-overlapping base address from a simple
bump allocator; the transfer engine rejects overlapping MRs.

Fault tolerance (both roles):
  * prefill crash → its connection epoch invalidates on every decode
    worker; in-flight requests whose KV lived there are re-routed and
    re-prefilled on a survivor;
  * decode crash → requests assigned there are re-routed: KV_QUEUED
    requests keep their prefill KV and just get a new decode worker;
    requests already pulled (prefill copy freed by COMPLETE) restart
    from prefill;
  * both paths also fire from liveness reaping
    (``ClusterScheduler.reap_dead``), not just explicit fail calls.

Port of ``src/repro/serving/disagg.py``: the service builds the port's
workers and transfer engine on one ``device`` (the card unless the
caller passes ``device="cpu"``; a CUDA request without a GPU raises).
``from_cluster_spec`` binds the port's copy of ``repro.topo``: the
workers are logical (all on the one device), but each pool is sized by
its bound machine's VRAM and the router prices the bound links.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.core.cluster import ClusterScheduler, MembershipEvent
from repro_torch.core.connection import ChipInfo, ConnectionManager, WorkerInfo
from repro_torch.core.transfer_engine import LinkModel, TransferEngine
from repro_torch.device import resolve_device
from repro_torch.fleet import FleetController
from repro_torch.fleet.admission import AdmissionDeferred
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sched import LoadReport, NoWorkersError, RequestRouter, RouteRequest
from repro_torch.serving.blocks import OutOfBlocks
from repro_torch.serving.engine import DecodeWorker, PrefillWorker
from repro_torch.serving.handle import RequestHandle
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.loop import ServeLoop, ServeLoopStalled
from repro_torch.serving.request import Request, RequestState

__all__ = ["DisaggService"]


@dataclasses.dataclass
class _HedgeTwin:
    """A hedged prefill's duplicate KV copy: worker + slab blocks + the
    (identical) first token.  Freed when the primary's transfer COMPLETEs
    (loser aborted); adopted by failover when the primary copy dies.
    Carries the twin's block hashes and quant scales so adoption swaps
    the FULL transfer-plan identity, not just the block ids — stale
    hashes/scales from the dead primary would dedup or dequantize against
    the wrong bytes."""

    worker_id: str
    blocks: list[int]
    first_token: int
    hashes: list[str] = dataclasses.field(default_factory=list)
    scales: list | None = None

_RETRYABLE = (
    RequestState.PREFILLING,
    RequestState.KV_QUEUED,
    RequestState.KV_TRANSFER,
)


def _winfo(wid: str, role: str) -> WorkerInfo:
    return WorkerInfo(wid, role, f"host-{wid}", (ChipInfo(0, f"ici://{wid}/0"),))


class DisaggService:
    def __init__(
        self,
        model,
        params,
        *,
        n_prefill: int = 1,
        n_decode: int = 1,
        num_blocks: int = 256,
        policy: str = "least_loaded",
        links: dict[tuple[str, str], LinkModel] | None = None,
        prefill_time_fn=None,
        slo_classes: dict[str, float] | None = None,
        consume: str = "full",
        delta_transfer: bool = True,
        quantize_transfer: bool = False,
        tracer=None,
        metrics=None,
        clock=None,
        fleet=None,
        device: str | torch.device = "cuda",
    ):
        """``consume`` ("full" | "layerwise") is the decode workers' pull
        consumption mode: "layerwise" starts a request's first decode step
        on early layers while the tail of its KV pull is still in flight
        (see DecodeWorker).

        ``delta_transfer`` lets decode workers graft resident blocks
        (retained prefixes, content-hash dedup hits) into admissions and
        pull only the missing suffix; ``quantize_transfer`` makes prefill
        workers compute per-block int8 scales at park time so pulls move
        quantized wire bytes (docs/transfer.md).  Both default to the
        paper-faithful full-precision pull being the fallback: a request
        with nothing resident behaves exactly as before.

        Observability (docs/observability.md): pass a ``repro_torch.obs.Tracer``
        as ``tracer`` to record per-request lifecycle spans and loop/engine
        phase spans (the default is the disabled no-op tracer); ``metrics``
        is the ``MetricsRegistry`` serve-path counters/histograms land in
        (one is created when omitted); ``clock`` is THE wall clock for
        every observability timestamp — tracer spans, handle metrics, and
        token times share it, so the span-derived breakdown and
        ``HandleMetrics`` agree exactly (a sim harness can inject a
        virtual clock and produce the identical span schema).

        ``fleet`` is an optional ``repro_torch.fleet.FleetConfig``: when given,
        a ``FleetController`` (autoscaling, memory-pressure preemption,
        KV-budget admission — docs/fleet.md) is built and stepped by the
        serving loop every tick.  Without it the service behaves exactly
        as before (no control plane).

        ``device`` is where every worker's model compute and KV slab live
        (the model's params must be there too)."""
        if consume not in ("full", "layerwise"):
            raise ValueError(f"consume must be 'full' or 'layerwise', got {consume!r}")
        self.consume = consume
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, service on {self.device}")
        self.delta_transfer = delta_transfer
        self.quantize_transfer = quantize_transfer
        self.model = model
        self.params = params
        self.obs_clock = clock if clock is not None else time.perf_counter
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if tracer is not None and clock is not None:
            tracer.clock = clock  # one clock: spans == handle metrics
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.scheduler = ClusterScheduler()
        self.engine = TransferEngine(coalescing="sorted", tracer=self.tracer,
                                     metrics=self.metrics)
        self._ids = itertools.count()
        self._wid_seq = {"p": itertools.count(), "d": itertools.count()}
        self._next_base = 0x7F00_0000_0000  # bump allocator for KV slabs
        self.clock = 0.0

        # Heterogeneous-cluster binding (topo.TopologyBinding), set by
        # from_cluster_spec: maps worker ids to machines, sizes pools by
        # VRAM, feeds the router per-pair links, and picks which spare
        # machine a fleet hot-add claims.  None = homogeneous service.
        self.topology = None

        self.prefills: dict[str, PrefillWorker] = {}
        self.decodes: dict[str, DecodeWorker] = {}
        self.conn_mgrs: dict[str, ConnectionManager] = {}
        self.pending: dict[str, tuple[Request, np.ndarray]] = {}  # in flight
        self.first_tokens: dict[str, int] = {}
        self.handles: dict[str, RequestHandle] = {}  # live (not yet DONE)
        self.hedges: dict[str, _HedgeTwin] = {}      # rid -> twin KV copy
        # The event-driven serving loop: every handle is driven by it,
        # whether the caller ticks it directly (streaming) or goes
        # through the generate/generate_many shims.
        self.loop = ServeLoop(self)
        # Fleet control plane (docs/fleet.md), stepped by the loop each
        # tick; admission is consulted by _dispatch.  Tests may attach a
        # bare AdmissionController to self.admission without a fleet.
        self.fleet = FleetController(self, fleet) if fleet is not None else None
        self.admission = self.fleet.admission if self.fleet is not None else None

        policy_kwargs = {"classes": slo_classes} if (
            policy == "slo" and slo_classes is not None) else {}
        self.router = RequestRouter(
            self.scheduler, policy, links=links,
            prefill_time_fn=prefill_time_fn, metrics=self.metrics,
            **policy_kwargs,
        )

        # COMPLETE() → prefill worker frees its blocks
        self.engine.on_complete(self._on_complete)
        # membership → connections + failover (explicit fails AND reaping)
        self.scheduler.subscribe(self._on_membership)

        for _ in range(n_decode):
            self.add_decode_worker(num_blocks=num_blocks)
        for _ in range(n_prefill):
            self.add_prefill_worker(num_blocks=num_blocks)

    # ---------------------------------------------------- topology entry
    @classmethod
    def from_cluster_spec(cls, model, params, spec, *, placement=None,
                          planner=None, seed: int = 0, num_blocks: int = 256,
                          policy: str = "network_aware", **kwargs):
        """Build a service from a ``topo.ClusterSpec``: plan prefill/
        decode roles over the topology (or take an explicit
        ``placement``), size each worker's KV pool by its machine's VRAM
        (``num_blocks`` = the largest machine's pool), and feed the
        router the per-pair ``LinkModel``s so ``network_aware`` /
        ``prefix_affinity`` routing prices real bandwidth + latency."""
        from repro_torch.topo import PlacementPlanner, TopologyBinding
        planner = planner if planner is not None else PlacementPlanner()
        if placement is None:
            placement = planner.plan(spec, seed=seed)
        binding = TopologyBinding(spec, placement, planner=planner)
        svc = cls(model, params, n_prefill=0, n_decode=0, policy=policy,
                  **kwargs)
        svc.topology = binding
        for _ in placement.decode:
            svc.add_decode_worker(num_blocks=num_blocks)
        for _ in placement.prefill:
            svc.add_prefill_worker(num_blocks=num_blocks)
        return svc

    # -------------------------------------------------- address space
    def _slab_bytes(self, num_blocks: int) -> int:
        cfg = self.model.cfg
        return PagedKVCache.slab_nbytes(
            num_layers=cfg.num_layers, num_blocks=num_blocks,
            block_size=self.model.BLOCK_SIZE, kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim)

    def _alloc_base(self, num_blocks: int) -> int:
        """Distinct, non-overlapping slab base per worker (1 MiB guard)."""
        base = self._next_base
        one_mib = 1 << 20
        span = -(-self._slab_bytes(num_blocks) // one_mib) * one_mib + one_mib
        self._next_base += span
        return base

    # ------------------------------------------------------- membership
    def _bind_topology(self, role: str, wid: str, num_blocks: int) -> int:
        """Topology-bound pool sizing: ``num_blocks`` is the reference
        (largest-VRAM) machine's pool; the bound machine gets a
        VRAM-proportional share.  Hot-adds claim the best spare machine
        (raising ``topo.NoSpareMachine`` on an exhausted cluster) and
        refresh the router's per-pair link map."""
        topo = self.topology
        if topo is None:
            return num_blocks
        m = topo.machine(wid)
        if m is None:  # hot-add beyond the placement: claim a spare
            m = topo.add_worker(role, wid)
        return max(1, round(num_blocks * m.profile.vram_bytes
                            / topo.spec.max_vram))

    def add_prefill_worker(self, *, num_blocks: int = 256) -> str:
        wid = f"p{next(self._wid_seq['p'])}"  # monotonic: ids never reused
        num_blocks = self._bind_topology("prefill", wid, num_blocks)
        w = PrefillWorker(_winfo(wid, "prefill"), self.model, self.params,
                          num_blocks=num_blocks,
                          base_address=self._alloc_base(num_blocks),
                          quantize_transfer=self.quantize_transfer,
                          tracer=self.tracer)
        self.prefills[wid] = w
        self.engine.register_memory(w.cache.memory_region())
        # seed liveness at the CURRENT clock, else a worker added late is
        # instantly reapable
        self.scheduler.add_worker(w.info, now=self.clock)  # broadcast → CONNECT
        if self.topology is not None:
            self.router.links.update(self.topology.links())
        return wid

    def add_decode_worker(self, *, num_blocks: int = 256) -> str:
        wid = f"d{next(self._wid_seq['d'])}"
        num_blocks = self._bind_topology("decode", wid, num_blocks)
        w = DecodeWorker(_winfo(wid, "decode"), self.model, self.params,
                         num_blocks=num_blocks, engine=self.engine,
                         base_address=self._alloc_base(num_blocks),
                         consume=self.consume,
                         delta_transfer=self.delta_transfer,
                         tracer=self.tracer, metrics=self.metrics)
        cm = ConnectionManager(w.info)
        cm.on_invalidate(self._on_prefill_invalidate)
        for pwid, pw in self.prefills.items():
            cm.connect(pw.info, pw.registry)
        self.decodes[wid] = w
        self.conn_mgrs[wid] = cm
        self.scheduler.add_worker(w.info, now=self.clock)
        if self.topology is not None:
            self.router.links.update(self.topology.links())
        return wid

    def fail_prefill_worker(self, wid: str) -> None:
        """Simulate a crash: scheduler reaps it; engine deregisters its MR;
        epochs invalidate on every decode worker; in-flight requests
        re-route."""
        self.scheduler.remove_worker(wid, failed=True)

    def fail_decode_worker(self, wid: str) -> None:
        """Simulate a decode crash: requests assigned there re-route."""
        self.scheduler.remove_worker(wid, failed=True)

    def reap_dead(self, now: float) -> list[str]:
        """Liveness-driven failover: lapsed heartbeats → same teardown
        path as an explicit failure."""
        self.clock = max(self.clock, now)
        return self.scheduler.reap_dead(now)

    def _on_membership(self, ev: MembershipEvent) -> None:
        wid = ev.worker.worker_id
        if ev.worker.role == "prefill":
            if ev.kind == "added":
                for cm in self.conn_mgrs.values():
                    cm.connect(ev.worker, self.prefills[wid].registry)
            else:
                self.engine.deregister_memory(wid)
                self.prefills.pop(wid, None)
                self.router.on_worker_failed(wid)
                for cm in self.conn_mgrs.values():
                    cm.disconnect(wid, failed=ev.kind == "failed")
                if ev.kind == "removed":
                    # graceful leave: no epoch invalidation fires, but the
                    # KV is leaving with the worker all the same — migrate
                    self._on_prefill_invalidate(wid, 0)
        elif ev.kind in ("removed", "failed"):  # decode leaving
            self.engine.deregister_memory(wid)
            self.decodes.pop(wid, None)
            self.conn_mgrs.pop(wid, None)
            self.router.on_worker_failed(wid)
            self._on_decode_failed(wid)  # graceful or crash: re-route

    # --------------------------------------------------------- failover
    def _on_prefill_invalidate(self, dead_worker: str, epoch: int) -> None:
        """A prefill epoch died (fired once per decode worker's table);
        re-route every request whose KV lived there.  Idempotent: after
        the first re-dispatch the request points at a live worker."""
        # hedge twins that lived on the dead worker are gone with it —
        # drop their entries so failover below can't adopt a dead copy
        for rid, twin in list(self.hedges.items()):
            if twin.worker_id == dead_worker:
                self.hedges.pop(rid, None)
        for rid, (req, tokens) in list(self.pending.items()):
            if req.prefill_worker == dead_worker and req.state in _RETRYABLE:
                self._restart(req, tokens)

    def _on_decode_failed(self, dead_worker: str) -> None:
        for rid, (req, tokens) in list(self.pending.items()):
            if req.decode_worker != dead_worker:
                continue
            if req.state == RequestState.KV_QUEUED:
                # prefill copy still alive — only the decode side moves
                req.retries += 1
                try:
                    self._assign_decode(req)
                    self.tracer.phase(("request", rid), "queue.kv",
                                      decode_worker=req.decode_worker)
                    self.metrics.inc("failover.decode_reassigned")
                except NoWorkersError:
                    self._park(req)
            elif req.state in (RequestState.KV_TRANSFER,
                               RequestState.QUEUED_DECODE,
                               RequestState.DECODING):
                # pulled KV died with the worker and the prefill copy was
                # freed by COMPLETE — restart from prefill
                self._restart(req, tokens)

    def _park(self, req: Request) -> None:
        """No capacity to re-route right now: park the request (stays in
        ``pending``; ``retry_parked`` revives it once capacity returns)."""
        if req.state is not RequestState.FAILED:
            req.to(RequestState.FAILED)
        req.decode_worker = None
        # parked wall time reads as queue time: the lifecycle track stays
        # a gap-free partition across a park/revive cycle
        self.tracer.phase(("request", req.request_id), "queue", parked=True)
        self.metrics.inc("failover.parked")

    def _restart(self, req: Request, tokens: np.ndarray) -> None:
        req.retries += 1
        self.metrics.inc("failover.restarts")
        self.tracer.instant("failover.restart", track=("request", req.request_id),
                            retries=req.retries)
        dw = self.decodes.get(req.decode_worker) if req.decode_worker else None
        if dw is not None:
            dw.abort(req.request_id)  # drop a dead in-flight pull, free blocks
        req.decode_blocks = []
        h = self.handles.get(req.request_id)
        if h is not None:
            h._reset_decoded()  # decode replays from scratch, identically
        primary_alive = bool(req.prefill_blocks) and req.prefill_worker in self.prefills
        if not primary_alive:
            twin = self.hedges.pop(req.request_id, None)
            if twin is not None and twin.worker_id in self.prefills:
                # hedged dispatch pays off: adopt the twin's surviving KV
                # copy — no re-prefill, the request just re-queues for
                # admission from the twin's slab
                req.prefill_worker = twin.worker_id
                req.prefill_blocks = list(twin.blocks)
                req.block_hashes = list(twin.hashes)
                req.kv_scales = twin.scales
                self.first_tokens[req.request_id] = twin.first_token
                self.metrics.inc("hedge.adopted")
                self.tracer.phase(("request", req.request_id), "queue.kv",
                                  adopted_twin=twin.worker_id)
                if h is not None:
                    h.metrics.hedge_adopted = True
                if req.state is not RequestState.KV_QUEUED:
                    req.to(RequestState.KV_QUEUED)
                try:
                    self._assign_decode(req)
                except NoWorkersError:
                    self._park(req)
                return
        if primary_alive:
            self.prefills[req.prefill_worker].release(req)  # stale live copy
        self._drop_hedge(req.request_id)  # re-dispatch may hedge afresh
        req.prefill_blocks = []
        if req.state is not RequestState.QUEUED_PREFILL:
            if req.state is not RequestState.FAILED:
                req.to(RequestState.FAILED)
            req.to(RequestState.QUEUED_PREFILL)
        self.router.forget(req.request_id)
        try:
            # already admitted once; re-hedge if the caller paid for it
            self._dispatch(req, tokens, force=True,
                           hedge=h.hedge if h is not None else 1)
        except (NoWorkersError, OutOfBlocks):
            # must not escape: callers include the membership broadcast —
            # a throw there would abort failover for the other requests
            self._park(req)

    def retry_parked(self, now: float | None = None) -> list[str]:
        """Re-dispatch requests parked by failover (call after adding
        workers or freeing capacity).  Returns the revived request ids."""
        if now is not None:
            self.clock = max(self.clock, now)
        revived = []
        for rid, (req, tokens) in list(self.pending.items()):
            if req.state is not RequestState.FAILED:
                continue
            if req.prefill_blocks and req.prefill_worker in self.prefills:
                # prefill KV survived (decode-side park): only the decode
                # assignment was lost — no need to recompute the prefill
                try:
                    self._assign_decode(req)
                except NoWorkersError:
                    continue
                req.to(RequestState.KV_QUEUED)
                self.tracer.phase(("request", rid), "queue.kv",
                                  decode_worker=req.decode_worker)
            else:
                self._restart(req, tokens)
                if req.state is RequestState.FAILED:
                    continue
            revived.append(rid)
        return revived

    # -------------------------------------------------------- fleet ops
    # Mechanism for repro_torch.fleet (docs/fleet.md): the MemoryGovernor and
    # FleetController decide WHAT to preempt/drain; these methods own the
    # page copies, ledger updates, tracer phases, and handle metrics.

    def swap_out_request(self, rid: str) -> bool:
        """Preempt a DECODING resident to the host swap pool.  The
        request stays pending (state DECODING, stream paused); False when
        it isn't resident or the pool's byte budget refuses the entry —
        the caller degrades to park behavior."""
        entry = self.pending.get(rid)
        if entry is None or self.fleet is None:
            return False
        req = entry[0]
        dw = self.decodes.get(req.decode_worker) if req.decode_worker else None
        if dw is None:
            return False
        swapped = dw.swap_out(rid)
        if swapped is None:
            return False
        if not self.fleet.swap_pool.put(rid, swapped, swapped.nbytes):
            dw.swap_in(swapped)  # budget refused; its blocks just freed, so this fits
            return False
        h = self.handles.get(rid)
        if h is not None:
            h.metrics.swapped_out += 1
        # paused wall time reads as queue time — the lifecycle track
        # stays a gap-free partition across a swap cycle (same
        # convention as parking)
        self.tracer.phase(("request", rid), "queue", swapped=True)
        self.metrics.inc("fleet.preempt_swap")
        return True

    def swap_in_request(self, rid: str, worker_id: str) -> bool:
        """Resume a swapped request on ``worker_id`` (any decode worker —
        the entry is worker-agnostic, which lets drains migrate swapped
        victims).  False when that worker can't hold it yet."""
        if self.fleet is None:
            return False
        swapped = self.fleet.swap_pool.get(rid)
        dw = self.decodes.get(worker_id)
        if swapped is None or dw is None:
            return False
        if not dw.swap_in(swapped):
            return False
        self.fleet.swap_pool.pop(rid)
        self.tracer.phase(("request", rid), "decode", worker=worker_id,
                          resumed=True)
        self.metrics.inc("fleet.resume_swap")
        return True

    def sacrifice_request(self, rid: str) -> bool:
        """Preempt by sacrifice: drop the resident's decode KV and replay
        through truncate-and-replay (``_restart``) — the replay re-pulls
        the KV and regenerates the identical stream (decode is
        deterministic)."""
        entry = self.pending.get(rid)
        if entry is None:
            return False
        req, tokens = entry
        dw = self.decodes.get(req.decode_worker) if req.decode_worker else None
        if dw is None or not dw.evict_resident(rid):
            return False
        h = self.handles.get(rid)
        if h is not None:
            h.metrics.sacrificed += 1
        self.metrics.inc("fleet.preempt_sacrifice")
        self._restart(req, tokens)
        return True

    def reassign_queued_off(self, worker_id: str) -> list[str]:
        """Move every KV_QUEUED request off a draining decode worker
        (their prefill KV stays put — only the pull destination changes).
        Stragglers the router can't place yet stay assigned; the drain
        waits for them."""
        moved = []
        for rid, (req, _) in list(self.pending.items()):
            if req.decode_worker != worker_id \
                    or req.state is not RequestState.KV_QUEUED:
                continue
            try:
                self._assign_decode(req)
            except NoWorkersError:
                continue
            if req.decode_worker != worker_id:
                self.tracer.phase(("request", rid), "queue.kv",
                                  decode_worker=req.decode_worker)
                moved.append(rid)
        return moved

    # ------------------------------------------------------------ loads
    def _report_loads(self, now: float | None = None) -> None:
        """Refresh every worker's LoadReport (the payload a worker's own
        heartbeat would piggyback, §4.2-style single control channel).
        Deliberately does NOT touch liveness timestamps: the serving
        layer reporting on a worker's behalf must not mask a dead worker
        from ``reap_dead`` — liveness comes from real heartbeats."""
        now = self.clock if now is None else now
        queued = {}  # KV_QUEUED footprint per decode worker: (tokens, count)
        for req, _ in self.pending.values():
            if req.state == RequestState.KV_QUEUED and req.decode_worker:
                t, c = queued.get(req.decode_worker, (0, 0))
                queued[req.decode_worker] = (t + req.prompt_len, c + 1)
        for wid, w in self.prefills.items():
            self.scheduler.report_load(wid, LoadReport(
                wid, "prefill", free_blocks=w.pool.num_free,
                total_blocks=w.pool.stats.capacity,
                block_size=w.block_size, t=now))
        for wid, w in self.decodes.items():
            q_tokens, q_depth = queued.get(wid, (0, 0))
            self.scheduler.report_load(wid, LoadReport(
                wid, "decode", free_blocks=w.pool.num_free,
                total_blocks=w.pool.stats.capacity,
                resident_requests=len(w.resident),
                queued_tokens=q_tokens, queue_depth=q_depth,
                block_size=w.block_size, t=now,
                prefix_ids=tuple(sorted(w.known_prefixes)),
                evictable_blocks=w.evictable_blocks,
                prefix_blocks=w.resident_prefix_blocks))

    # ------------------------------------------------------------ serve
    def _ctx(self, req: Request) -> RouteRequest:
        blocks = -(-req.prompt_len // self.model.BLOCK_SIZE)
        return RouteRequest(req.request_id, req.prompt_len,
                            kv_bytes=self._slab_bytes(blocks),
                            slo_class=req.slo_class, arrival_s=req.arrival_s,
                            prefix_id=req.prefix_id)

    def _assign_decode(self, req: Request) -> None:
        self._report_loads()
        req.decode_worker = self.router.reassign_decode(
            self._ctx(req), req.prefill_worker)

    def _dispatch(self, req: Request, tokens: np.ndarray, *,
                  force: bool = False, hedge: int = 1) -> None:
        self._report_loads()
        if self.admission is not None and not force:
            # KV-budget admission (docs/fleet.md): reject/defer before
            # any prefill compute is spent.  force (failover re-dispatch)
            # bypasses it — the request was already admitted once.
            need = -(-req.prompt_len // self.model.BLOCK_SIZE)
            self.admission.check(self.scheduler.loads("decode"), need,
                                 req.request_id)
        decision = self.router.route(self._ctx(req), now=self.clock, force=force)
        req.prefill_worker = decision.prefill_worker
        req.decode_worker = decision.decode_worker
        tr = ("request", req.request_id)
        w = self.prefills[decision.prefill_worker]
        self.tracer.phase(tr, "prefill", worker=decision.prefill_worker)
        try:
            self.first_tokens[req.request_id] = w.prefill(req, tokens)
        except Exception:
            self.tracer.phase(tr, "queue")  # prefill never ran: back to queued
            self.router.forget(req.request_id)  # retire the ledger charge
            raise
        req.to(RequestState.KV_QUEUED)
        self.tracer.phase(tr, "queue.kv", decode_worker=decision.decode_worker)
        self.metrics.inc("requests.dispatched")
        if hedge > 1:
            self._dispatch_hedge(req, tokens)
        h = self.handles.get(req.request_id)
        if h is not None and not h.tokens:
            h._push(self.first_tokens[req.request_id])

    def _dispatch_hedge(self, req: Request, tokens: np.ndarray) -> None:
        """Run a duplicate prefill on a SECOND worker picked by the
        router.  The twin's KV copy rides along until the primary's
        transfer COMPLETEs (then it is aborted and its slab freed) or the
        primary dies first (then failover adopts it without re-prefill).
        Degrades silently when no second worker exists or its pool is
        full — hedging is opportunistic."""
        twin_wid = self.router.pick_hedge_prefill(
            self._ctx(req), {req.prefill_worker}, now=self.clock)
        if twin_wid is None:
            return
        try:
            first, blocks, hashes, scales = \
                self.prefills[twin_wid].prefill_shadow(tokens)
        except OutOfBlocks:
            self.router.forget_hedge(req.request_id)  # twin never ran
            return
        self.hedges[req.request_id] = _HedgeTwin(twin_wid, blocks, first,
                                                 hashes, scales)
        self.metrics.inc("hedge.dispatched")
        self.tracer.instant("hedge.dispatch", track=("request", req.request_id),
                            twin=twin_wid)
        h = self.handles.get(req.request_id)
        if h is not None:
            h.metrics.hedged = True

    def _drop_hedge(self, rid: str) -> None:
        """The race is decided (COMPLETE, finish, or restart): abort the
        losing twin and free its slab."""
        twin = self.hedges.pop(rid, None)
        if twin is None:
            return
        self.metrics.inc("hedge.aborted")
        w = self.prefills.get(twin.worker_id)
        if w is not None:
            w.pool.free(twin.blocks)

    def submit(self, tokens: np.ndarray, *, slo_class: str = "standard",
               now: float | None = None, max_new: int | None = None,
               eos_token: int | None = None, hedge: int = 1,
               prefix_id: str | None = None, prefix_len: int = 0,
               dispatch: str = "eager") -> RequestHandle:
        """Submit one request; returns a ``RequestHandle`` immediately.

        ``dispatch="eager"`` (default, the historical behavior) routes
        and prefills synchronously — ``sched.AdmissionRejected`` raises
        here if the SLO controller projects a missed deadline.
        ``dispatch="queued"`` returns with the request still QUEUED; the
        serving loop's next ``tick()`` routes and prefills it (an
        admission rejection then surfaces on the handle as FAILED).

        ``max_new``/``eos_token`` bound decode for loop-driven serving
        (``max_new=None`` defers the budget to the generate shims);
        ``hedge=2`` dispatches a twin prefill via the router (first
        COMPLETE wins, the loser's slab is freed); ``prefix_id`` (with
        optional ``prefix_len``, 0 = whole prompt) tags the request's
        shared prefix for prefix-affinity routing and retention."""
        if dispatch not in ("eager", "queued"):
            raise ValueError(f"dispatch must be 'eager' or 'queued', got {dispatch!r}")
        if now is not None:
            self.clock = max(self.clock, now)  # never rewind the clock
        req = Request(f"r{next(self._ids)}", len(tokens), max_new or 0,
                      arrival_s=self.clock, slo_class=slo_class,
                      prefix_id=prefix_id, prefix_len=prefix_len)
        handle = RequestHandle(req, self, max_new=max_new,
                               eos_token=eos_token, hedge=hedge,
                               clock=self.obs_clock)
        self.pending[req.request_id] = (req, tokens)
        self.handles[req.request_id] = handle
        # the request's lifecycle track opens at the SAME timestamp the
        # handle metrics anchor on, so breakdown ttlt == HandleMetrics.ttlt_s
        self.tracer.phase(("request", req.request_id), "queue",
                          ts=handle.metrics.submitted_at,
                          prompt_len=req.prompt_len, slo=slo_class)
        self.metrics.inc("requests.submitted")
        if dispatch == "eager":
            try:
                self._dispatch(req, tokens, hedge=hedge)
            except AdmissionDeferred:
                pass  # stays QUEUED_PREFILL; the loop dispatches later
            except Exception:
                self.pending.pop(req.request_id, None)
                self.handles.pop(req.request_id, None)
                raise
        return handle

    def _on_complete(self, txn) -> None:
        w = self.prefills.get(txn.src_worker)
        req = next((r for r, _ in self.pending.values()
                    if r.request_id == txn.request_id), None)
        if w is not None and req is not None:
            w.release(req)
        # the primary's pull landed: the hedge race (if any) is decided —
        # "first COMPLETE wins" — so the twin is aborted and freed
        self._drop_hedge(txn.request_id)

    def admit_to_decode(self, req) -> bool:
        """Pull the KV into the assigned decode worker; False if its pool
        is full (request stays KV_QUEUED; prefill KV stays alive)."""
        req = getattr(req, "request", req)  # accept handle or Request
        cm = self.conn_mgrs[req.decode_worker]
        conn = cm.connection(req.prefill_worker)
        try:
            self.decodes[req.decode_worker].admit(
                req, conn, self.first_tokens[req.request_id])
        except OutOfBlocks:
            return False
        return True

    # -------------------------------------------------- batched admission
    def admit_queued(self, *, max_batch: int | None = None,
                     only: set[str] | None = None) -> dict[str, list[str]]:
        """Router-planned admission batches: every KV_QUEUED request
        (restricted to ``only`` when given) is grouped by its assigned
        decode worker (capacity-capped, FIFO by arrival) and its pull is
        SUBMITTED — not drained.  The transfers advance via ``pump()`` /
        the decode workers' interleaved rounds, so transfer time hides
        behind decode compute.  Returns the request ids actually admitted
        per worker."""
        self._report_loads()
        queued = [
            (self._ctx(req), req.decode_worker)
            for req, _ in self.pending.values()
            if req.state is RequestState.KV_QUEUED
            and req.decode_worker in self.decodes
            and (only is None or req.request_id in only)
        ]
        if not queued:
            return {}
        plan = self.router.plan_admissions(queued, max_batch=max_batch)
        admitted: dict[str, list[str]] = {}
        for wid, rids in plan.items():
            dw = self.decodes[wid]
            cm = self.conn_mgrs[wid]
            batch = [
                (self.pending[rid][0],
                 cm.connection(self.pending[rid][0].prefill_worker),
                 self.first_tokens[rid])
                for rid in rids
            ]
            futures = dw.admit_batch(batch)
            if futures:
                admitted[wid] = [f.request_id for f in futures]
        return admitted

    def pump(self, budget: int | None = None) -> list[str]:
        """Advance in-flight pulls on every decode worker; returns request
        ids promoted to DECODING."""
        promoted: list[str] = []
        for dw in list(self.decodes.values()):
            promoted.extend(dw.pump(budget))
        return promoted

    def _reject_queued(self, rid: str, err: Exception) -> None:
        """A queued submission failed admission at dispatch time: mark
        the handle FAILED (terminally — rejection is a decision, not a
        capacity blip) and drop the service-side ledger entries."""
        entry = self.pending.pop(rid, None)
        if entry is not None and entry[0].state is not RequestState.FAILED:
            entry[0].to(RequestState.FAILED)
        self.tracer.end_phase(("request", rid), rejected=str(err))
        self.metrics.inc("requests.rejected")
        h = self.handles.pop(rid, None)
        if h is not None:
            h.error = err

    # --------------------------------------------------------- completion
    def _finish_request(self, rid: str) -> None:
        """Retire a request that finished decoding (budget reached or
        EOS): free its decode blocks, drop every ledger entry, and seal
        the handle's pulled-bytes metric."""
        h = self.handles.pop(rid, None)
        if h is not None:
            # seal BEFORE DecodeWorker.finish pops the engine's counters
            h.metrics.kv_bytes_pulled = self.engine.pulled_bytes(rid)
            h.metrics.kv_bytes_reused = self.engine.reused_bytes(rid)
            # close the lifecycle track AT the last token's timestamp, so
            # the span partition's extent equals HandleMetrics.ttlt_s
            self.tracer.end_phase(("request", rid), ts=h.metrics.last_token_at)
            m, hm = self.metrics, h.metrics
            m.inc("requests.finished")
            m.inc("request.kv_bytes_pulled", hm.kv_bytes_pulled)
            m.inc("request.kv_bytes_reused", hm.kv_bytes_reused)
            if hm.kv_bytes_pulled or hm.kv_bytes_reused:
                m.observe("request.kv_reuse_frac", hm.kv_reuse_frac)
            if hm.ttft_s is not None:
                m.observe("request.ttft_s", hm.ttft_s)
            if hm.ttlt_s is not None:
                m.observe("request.ttlt_s", hm.ttlt_s)
            if hm.tbt_s is not None:
                m.observe("request.tbt_s", hm.tbt_s)
        req_entry = self.pending.pop(rid, None)
        if req_entry is not None:
            req = req_entry[0]
            dw = self.decodes.get(req.decode_worker) if req.decode_worker else None
            if dw is not None:
                dw.finish(rid)
            if req.state is not RequestState.DONE:
                # early finish (EOS from prefill / zero budget): no pull
                # ever ran, so no COMPLETE will free the prefill copy —
                # release it here
                if req.prefill_blocks and req.prefill_worker in self.prefills:
                    self.prefills[req.prefill_worker].release(req)
                req.to(RequestState.DONE)
        self.engine.pulled_bytes(rid, pop=True)
        self.engine.reused_bytes(rid, pop=True)
        self.router.forget(rid)
        self._drop_hedge(rid)
        self.first_tokens.pop(rid, None)

    def _handle_of(self, req) -> RequestHandle:
        """Normalize a caller-held object (RequestHandle or bare Request)
        to its live handle."""
        if isinstance(req, RequestHandle):
            return req
        h = self.handles.get(req.request_id)
        if h is None:  # a bare Request never submitted through us
            raise KeyError(f"unknown request {req.request_id!r}")
        return h

    # ------------------------------------------------------------- shims
    def generate_many(self, reqs: list, max_new: int = 8, *,
                      pump_budget: int | None = 32) -> dict[str, list[int]]:
        """Batch shim over the event-driven serving loop: give every
        request a ``max_new`` decode budget and tick ``ServeLoop`` until
        each is DONE (or parked).  Under the hood this is CONTINUOUS
        batching — requests join decode as their pulls land and leave at
        their budget without stalling cohabitants — but the call shape
        (and, per request, the tokens) match the old round-synchronous
        API exactly.

        Requests parked by failover (no capacity) are skipped — revive
        them with ``retry_parked()`` and call again.  Returns
        request_id → [first_token, *decoded] for every finished request."""
        handles = [self._handle_of(r) for r in reqs]
        for h in handles:
            if not h.done:
                h.max_new = max_new
        prev_budget = self.loop.pump_budget
        self.loop.pump_budget = pump_budget
        try:
            self.loop.run_until_idle(only={h.request_id for h in handles})
        finally:
            self.loop.pump_budget = prev_budget  # shared loop: don't leak
        return {h.request_id: list(h.tokens[: 1 + max_new])
                for h in handles if h.done}

    def generate(self, req, max_new: int = 8) -> list[int]:
        """Single-request shim — the SAME loop path as ``generate_many``
        (no separate dispatch code to drift).  Preserves the historical
        error contract: RuntimeError for a parked request, OutOfBlocks
        when the decode pool cannot hold it."""
        h = self._handle_of(req)
        if h.request.state is RequestState.FAILED:
            h._raise_failed()  # rejection error, or "parked" RuntimeError
        try:
            out = self.generate_many([h], max_new=max_new)
        except ServeLoopStalled:
            if h.request.state is RequestState.KV_QUEUED:
                raise OutOfBlocks("decode pool full")
            raise
        if h.request_id not in out:
            h._raise_failed()  # parked (or rejected) during the drive
        return out[h.request_id]

    # ------------------------------------------------- single-decode API
    @property
    def decode(self) -> DecodeWorker:
        """Oldest decode worker (compat for single-decode callers).
        Numeric sort: ids are monotonic, so lexicographic would misorder
        d10 before d2."""
        if not self.decodes:
            raise NoWorkersError("no live decode workers")
        return self.decodes[min(self.decodes, key=lambda w: int(w[1:]))]

    @property
    def conn_mgr(self) -> ConnectionManager:
        """Oldest decode worker's connection table (compat)."""
        if not self.conn_mgrs:
            raise NoWorkersError("no live decode workers")
        return self.conn_mgrs[min(self.conn_mgrs, key=lambda w: int(w[1:]))]
