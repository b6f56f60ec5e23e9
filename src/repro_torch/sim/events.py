"""Discrete-event cluster simulator for disaggregated LLM serving.

Reproduces the paper's latency experiments (Figs. 6, 12, 13, 14, 16, 17)
at cluster scale on a laptop: Poisson arrivals, xP yD worker topologies,
continuous-batching decode, KV-capacity admission, pull- vs push-mode
transfer semantics, and a colocated prefill-prioritizing baseline
(the paper's vLLM comparison).

Mechanism fidelity:
  * pull-mode — decode-side KV is allocated only when prefill FINISHES;
    prefill-side KV is held until COMPLETE (end of transfer); a full
    decode pool queues requests while their prefill-side KV stays alive
    and the prefill worker keeps computing other requests (§4.3).
  * push-mode — decode-side KV is RESERVED at admission (before prefill
    starts); transfer overlaps prefill layer-by-layer, so its visible
    tail is one layer's worth; a full decode pool blocks prefill from
    even starting (Motivation #3).
  * colocated — one worker pool does both stages, prefill prioritized at
    iteration boundaries (vLLM-like): a long prefill stalls every
    resident decode for its duration (the TBT blow-up of Fig. 13).

Timing comes from sim.costs.CostModel; transfer timing shares the SAME
LinkModel as the real transfer engine.

Copy of ``src/repro/sim/events.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable

import numpy as np

from repro_torch.fleet.autoscale import Autoscaler as FleetAutoscaler
from repro_torch.fleet.config import DEFAULT_CLASS_RANK, FleetConfig
from repro_torch.sched.load import LoadReport
from repro_torch.sched.policies import Candidate, Policy, RouteRequest, make_policy
from repro_torch.serving.request import Request, RequestState
from repro_torch.sim.costs import CostModel
from repro_torch.sim.workloads import SimRequest

__all__ = ["ClusterSim", "SimConfig", "SimResults", "percentile"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_prefill: int = 1
    n_decode: int = 1
    mode: str = "pull"            # pull | push | colocated
    transfer_mode: str = "tensor_centric"  # tensor_centric | message
    coalesce_factor: float = 8.0
    max_decode_batch: int = 64
    reserve_response: bool = True  # reserve prompt+response tokens at admission
    # straggler mitigation: if a prefill exceeds hedge_factor × its nominal
    # time, duplicate it on an idle worker; first finisher wins
    hedge_prefill: bool = False
    hedge_factor: float = 2.0
    # scheduling: sched.policies name driving prefill/decode placement
    # (round_robin | least_loaded | network_aware | slo)
    policy: str = "least_loaded"
    # TTFT deadline (s) for policy="slo": arrivals whose projected TTFT
    # exceeds it are rejected at admission instead of degrading everyone
    slo_s: float | None = None
    # Transfer-engine model (pull mode): how a decode worker's KV pulls
    # interact with its decode iterations, and WHEN a request becomes
    # decodable (its consumer mode).
    #   "blocking"   — the synchronous engine: the worker sits in drain()
    #                  for the whole pull, so decode iterations and
    #                  transfers mutually exclude on the worker.
    #   "pipelined"  — pulls serialize on the NIC but never block decode;
    #                  a request joins decode when its whole pull lands.
    #   "overlapped" — the async engine with FULL-PULL consumption (the
    #                  serving path's consume="full"): decode never
    #                  blocks, admissions batch, but the first decode
    #                  step still waits for COMPLETE — so the join point
    #                  is the last byte, same as "pipelined".  Kept as a
    #                  distinct name so sweeps can label the engine
    #                  generation they model.
    #   "layerwise"  — the pipelined attention consumer (the serving
    #                  path's consume="layerwise"): the first decode step
    #                  runs layer l's attention as soon as layer l's
    #                  reads land, so the request joins decode once its
    #                  layer-0 KV arrives (visible tail = one layer's
    #                  share, costs.transfer_layer_tail_s); COMPLETE —
    #                  and the prefill-side free — still waits for the
    #                  last byte.
    transfer_overlap: str = "pipelined"
    # max KV_QUEUED admissions started per scheduling opportunity
    # (0 = admit everything that fits; 1 = one-shot admission)
    admission_batch: int = 0
    # Decode batching discipline — the admission semantics the REAL
    # serving layer exposes, so the simulator and service stay honest
    # with each other:
    #   "continuous" — requests join the running batch at the next
    #                  iteration boundary and leave as they finish (the
    #                  ServeLoop / DecodeWorker.step path);
    #   "round"      — the legacy round-synchronous generate_many: a
    #                  worker freezes its cohort when a round starts;
    #                  requests arriving mid-round wait for the WHOLE
    #                  cohort to drain before decoding begins (their
    #                  decode_start_s — and so KV-inclusive TTFT — eats
    #                  the cohort tail).
    batching: str = "continuous"
    # Delta transfer (pull mode): decode workers retain finished
    # requests' shared-prefix KV (LRU over prefix ids, bounded by
    # prefix_cache_cap) and pull only the suffix for a later request
    # with the same prefix — the sim twin of DecodeWorker's delta
    # admission (docs/transfer.md).
    delta_transfer: bool = False
    prefix_cache_cap: int = 4
    # Quantized transfer: int8 wire format halves the bytes actually
    # moved (per-span scales are noise at this scale); compute is
    # unchanged — the slab dequantizes on landing.
    quantize_transfer: bool = False
    # ---- fleet mirror (docs/fleet.md): the SAME policy space as
    # repro_torch.fleet, so swap-vs-sacrifice and autoscaling choices rank in
    # simulation before they run on the real substrate. ----
    # Memory-pressure preemption (pull mode): what a decode worker does
    # when its pool is >= preempt_high full and the head waiter doesn't
    # fit even after prefix eviction.  "swap" parks the victim's KV in
    # host memory (resume priced at swap_cost_scale x the wire transfer
    # of its context); "sacrifice" drops it and replays from prefill.
    preemption: str = "none"        # none | swap | sacrifice
    victim_policy: str = "lifo"     # lifo | fifo | priority
    preempt_high: float = 0.92
    swap_cost_scale: float = 0.25
    max_preemptions: int = 2
    # Autoscaling (pull mode): the sim drives the REAL repro_torch.fleet
    # Autoscaler (same decision code) on LoadReports built from sim
    # worker state, evaluated every autoscale_interval_s.  Shrink is
    # drain-then-retire, exactly like the serving layer.
    autoscale: bool = False
    autoscale_interval_s: float = 5.0
    autoscale_up: float = 0.85
    autoscale_down: float = 0.25
    autoscale_patience: int = 2
    min_prefill: int = 1
    max_prefill: int = 4
    min_decode: int = 1
    max_decode: int = 4
    total_cap: int | None = None    # equal-peak-hardware P/D-ratio mode
    # Completed-by-horizon accounting: requests DONE by horizon_s count
    # as completed in SimResults.summary() (None = end of sim).
    horizon_s: float | None = None


@dataclasses.dataclass
class SimResults:
    requests: list[Request]
    rejected: list[Request] = dataclasses.field(default_factory=list)
    # Delta-transfer accounting (tokens, per request): what moved on the
    # wire vs what a delta plan served from resident prefix KV.
    pulled_tokens: dict[str, int] = dataclasses.field(default_factory=dict)
    reused_tokens: dict[str, int] = dataclasses.field(default_factory=dict)
    # Fleet-mirror accounting: preemption action counts and the horizon
    # for completed-by-horizon throughput (None = end of sim).
    n_swapped: int = 0
    n_sacrificed: int = 0
    horizon_s: float | None = None

    def completed_by(self, t: float | None = None) -> int:
        """Requests DONE by ``t`` (default: the configured horizon; no
        horizon = all finished requests) — the throughput metric that
        makes park-only vs preemption comparable: parked work that never
        ran counts as zero, not as 'still pending'."""
        t = self.horizon_s if t is None else t
        if t is None:
            return len(self.requests)
        return sum(1 for r in self.requests
                   if r.done_s is not None and r.done_s <= t)

    def _metric(self, fn) -> list[float]:
        return [v for v in (fn(r) for r in self.requests) if v is not None]

    @staticmethod
    def _ttft_kv(r: Request) -> float | None:
        if r.decode_start_s is None:
            return None
        return r.decode_start_s - r.arrival_s

    def p(self, q: float, fn) -> float:
        vals = self._metric(fn)
        return float(np.percentile(vals, q)) if vals else float("nan")

    def summary(self) -> dict[str, float]:
        return {
            "n": len(self.requests),
            "n_rejected": len(self.rejected),
            "p50_total_s": self.p(50, lambda r: r.total_latency_s),
            "p90_total_s": self.p(90, lambda r: r.total_latency_s),
            "p50_ttft_s": self.p(50, lambda r: r.ttft_s),
            "p90_ttft_s": self.p(90, lambda r: r.ttft_s),
            "p50_tbt_s": self.p(50, lambda r: r.tbt_s),
            "p90_tbt_s": self.p(90, lambda r: r.tbt_s),
            # KV-inclusive TTFT (paper §5.1: TTFT "includes the waiting
            # time for the KV cache"): arrival → request decodable on the
            # decode worker.  The metric the transfer-overlap engine moves.
            "p50_ttft_kv_s": self.p(50, self._ttft_kv),
            "p90_ttft_kv_s": self.p(90, self._ttft_kv),
            "mean_total_s": float(np.mean(self._metric(lambda r: r.total_latency_s) or [np.nan])),
            "mean_pulled_tokens": float(np.mean(list(self.pulled_tokens.values()))
                                        if self.pulled_tokens else 0.0),
            "mean_reused_tokens": float(np.mean(list(self.reused_tokens.values()))
                                        if self.reused_tokens else 0.0),
            "kv_reuse_frac": self._reuse_frac(),
            "completed": self.completed_by(),
            "n_swapped": self.n_swapped,
            "n_sacrificed": self.n_sacrificed,
        }

    def _reuse_frac(self) -> float:
        pulled = sum(self.pulled_tokens.values())
        reused = sum(self.reused_tokens.values())
        total = pulled + reused
        return reused / total if total else 0.0

    def mean_breakdown(self) -> dict[str, float]:
        keys = ["prefill_queue_s", "prefill_s", "transfer_s", "decode_queue_s", "decode_s"]
        acc = {k: 0.0 for k in keys}
        n = 0
        for r in self.requests:
            if r.done_s is None:
                continue
            b = r.breakdown()
            for k in keys:
                acc[k] += b[k]
            n += 1
        return {k: v / max(n, 1) for k, v in acc.items()}


def percentile(vals, q):
    return float(np.percentile(vals, q)) if len(vals) else float("nan")


# ----------------------------------------------------------------------
class _PrefillWorker:
    def __init__(self, wid: str, cap_tokens: int, slowdown: float = 1.0):
        self.wid = wid
        self.busy_until = 0.0
        self.held_tokens = 0      # KV held until COMPLETE (pull) / pushed (push)
        self.cap_tokens = cap_tokens
        self.slowdown = slowdown  # >1 = straggling node
        self.draining = False     # no new work; retires when idle + empty


class _DecodeWorker:
    def __init__(self, wid: str, cap_tokens: int, cfg: SimConfig,
                 slowdown: float = 1.0):
        self.wid = wid
        self.cap_tokens = cap_tokens
        self.slowdown = slowdown  # >1 = slower HBM than the reference node
        self.used_tokens = 0
        self.active: list[Request] = []
        self.kv_queue: list[Request] = []      # pull: waiting for decode KV
        self.round_wait: list[Request] = []    # round batching: next cohort
        self.nic_free_at = 0.0
        self.pull_busy_until = 0.0  # blocking engine: worker stuck in drain()
        self.iter_end = 0.0         # end of the in-flight decode iteration
        self.iterating = False
        self.cfg = cfg
        # Delta transfer: retained prefix KV (prefix_id -> tokens held),
        # LRU over insertion order; the held tokens stay in used_tokens
        # until eviction — the sim twin of DecodeWorker.prefix_cache.
        self.prefix_cache: dict[str, int] = {}
        # Fleet mirror: swapped-out victims (FIFO resume order; base
        # alloc tokens recharged at swap-in), drain flag, and in-flight
        # pull count (a draining worker retires only when all are zero).
        self.swapped: list[tuple[Request, int]] = []
        self.draining = False
        self.inflight_pulls = 0

    def free_tokens(self) -> int:
        return self.cap_tokens - self.used_tokens


class ClusterSim:
    """Heap-driven event loop.  Synchronous callbacks, deterministic."""

    def __init__(self, cost: CostModel, sim_cfg: SimConfig,
                 *, prefill_slowdowns: dict[str, float] | None = None,
                 link_scales: dict[tuple[str, str], float] | None = None,
                 symmetric_links: bool = False,
                 topology=None):
        self.cost = cost
        self.cfg = sim_cfg
        self._heap: list = []
        self._seq = itertools.count()
        self.now = 0.0
        cap = cost.kv_capacity_tokens()
        self._cap = cap
        self._slowdowns = dict(prefill_slowdowns or {})
        # Heterogeneous topology (topo.TopologyBinding): per-machine
        # capability scales and per-pair bandwidth/latency replayed from
        # the SAME ClusterSpec the real service binds — mutually
        # exclusive with the flat link_scales/prefill_slowdowns knobs.
        if topology is not None:
            if link_scales:
                raise ValueError("topology and link_scales are mutually "
                                 "exclusive — the binding derives pair costs")
            if prefill_slowdowns:
                raise ValueError("topology and prefill_slowdowns are mutually "
                                 "exclusive — the binding derives slowdowns")
            if sim_cfg.mode == "colocated":
                raise ValueError("topology models a disaggregated cluster "
                                 f"(mode={sim_cfg.mode!r})")
            if (topology.n_prefill, topology.n_decode) != \
                    (sim_cfg.n_prefill, sim_cfg.n_decode):
                raise ValueError(
                    f"topology binds {topology.n_prefill}P+{topology.n_decode}D "
                    f"but SimConfig says {sim_cfg.n_prefill}P+{sim_cfg.n_decode}D")
        self.topology = topology
        self.prefills = [self._new_prefill(f"p{i}")
                         for i in range(sim_cfg.n_prefill)]
        self.decodes = [self._new_decode(f"d{i}")
                        for i in range(sim_cfg.n_decode)]
        # hot-added worker ids continue the seed numbering (never reused)
        self._wid_p = itertools.count(sim_cfg.n_prefill)
        self._wid_d = itertools.count(sim_cfg.n_decode)
        self.prefill_queue: list[Request] = []
        self.push_admission: list[Request] = []
        self._meta: dict[str, SimRequest] = {}
        self.finished: list[Request] = []
        self.rejected: list[Request] = []
        # delta-transfer accounting (tokens): wire vs resident-graft,
        # plus what each admission actually drew from its worker's pool
        self.pulled_tokens: dict[str, int] = {}
        self.reused_tokens: dict[str, int] = {}
        self._alloc_tokens: dict[str, int] = {}
        # per-(prefill, decode) link multiplier on transfer time — the
        # skewed topology the network-aware policy exploits (NetKV).
        # Keys are validated against the worker-id space up front: a typo
        # or a reversed (decode, prefill) pair used to silently fall back
        # to 1.0 and quietly un-skew the experiment.
        self.link_scales = self._validate_link_scales(
            link_scales or {}, symmetric_links)
        if sim_cfg.transfer_overlap not in (
                "pipelined", "blocking", "overlapped", "layerwise"):
            raise ValueError(
                f"transfer_overlap must be pipelined|blocking|overlapped|"
                f"layerwise, got {sim_cfg.transfer_overlap!r}")
        if sim_cfg.batching not in ("continuous", "round"):
            raise ValueError(
                f"batching must be continuous|round, got {sim_cfg.batching!r}")
        if sim_cfg.batching == "round" and sim_cfg.mode == "colocated":
            raise ValueError(
                "batching='round' models the disaggregated generate_many "
                "cohorts; the colocated baseline has its own iteration rule")
        if sim_cfg.policy == "slo":
            if sim_cfg.slo_s is None:
                raise ValueError(
                    "SimConfig(policy='slo') requires slo_s — admission "
                    "against an unconfigured default deadline would "
                    "silently drop requests")
            self.policy = make_policy("slo", classes={"standard": sim_cfg.slo_s})
        else:
            self.policy = make_policy(sim_cfg.policy)
        # ---- fleet mirror ----
        if sim_cfg.preemption not in ("none", "swap", "sacrifice"):
            raise ValueError(
                f"preemption must be none|swap|sacrifice, got {sim_cfg.preemption!r}")
        if sim_cfg.victim_policy not in ("lifo", "fifo", "priority"):
            raise ValueError(
                f"victim_policy must be lifo|fifo|priority, got {sim_cfg.victim_policy!r}")
        if sim_cfg.preemption != "none" and sim_cfg.mode != "pull":
            raise ValueError("preemption models the pull-mode decode pool "
                             f"(mode={sim_cfg.mode!r})")
        if sim_cfg.autoscale and sim_cfg.mode != "pull":
            raise ValueError(f"autoscale requires mode='pull' (got {sim_cfg.mode!r})")
        self.n_swapped = 0
        self.n_sacrificed = 0
        self._preempt_count: dict[str, int] = {}
        self._tok_at_preempt: dict[str, int] = {}
        self._n_expected = 0
        if sim_cfg.autoscale:
            # the REAL autoscaler decision code (repro_torch.fleet), fed
            # LoadReports built from sim worker state — the decision
            # path cannot drift between sim and serving layer
            self.autoscaler = FleetAutoscaler(FleetConfig(
                autoscale=True,
                min_prefill=sim_cfg.min_prefill, max_prefill=sim_cfg.max_prefill,
                min_decode=sim_cfg.min_decode, max_decode=sim_cfg.max_decode,
                total_cap=sim_cfg.total_cap,
                scale_up=sim_cfg.autoscale_up, scale_down=sim_cfg.autoscale_down,
                patience=sim_cfg.autoscale_patience))
        else:
            self.autoscaler = None

    # ----------------------------------------------------------- topology
    def _new_prefill(self, wid: str) -> _PrefillWorker:
        topo = self.topology
        if topo is None:
            return _PrefillWorker(wid, self._cap, self._slowdowns.get(wid, 1.0))
        if topo.machine(wid) is None:  # hot-add: claim the best spare
            topo.add_worker("prefill", wid)
        cap = max(1, int(self._cap * topo.cap_scale(wid, self.cost.hw.hbm_bytes)))
        return _PrefillWorker(
            wid, cap, topo.prefill_slowdown(wid, self.cost.hw.peak_flops))

    def _new_decode(self, wid: str) -> _DecodeWorker:
        topo = self.topology
        if topo is None:
            return _DecodeWorker(wid, self._cap, self.cfg)
        if topo.machine(wid) is None:
            topo.add_worker("decode", wid)
        cap = max(1, int(self._cap * topo.cap_scale(wid, self.cost.hw.hbm_bytes)))
        return _DecodeWorker(
            wid, cap, self.cfg,
            slowdown=topo.decode_slowdown(wid, self.cost.hw.hbm_bw))

    def _validate_link_scales(self, scales, symmetric: bool):
        n_p = max(self.cfg.n_prefill,
                  self.cfg.max_prefill if self.cfg.autoscale else 0)
        n_d = max(self.cfg.n_decode,
                  self.cfg.max_decode if self.cfg.autoscale else 0)
        pids = {f"p{i}" for i in range(n_p)}
        dids = {f"d{i}" for i in range(n_d)}
        out: dict[tuple[str, str], float] = {}
        for (a, b), v in scales.items():
            if a in pids and b in dids:
                key = (a, b)
            elif a in dids and b in pids:
                if not symmetric:
                    raise ValueError(
                        f"link_scales key {(a, b)} is (decode, prefill) — "
                        "keys are directed (prefill, decode); pass "
                        "symmetric_links=True for undirected scales")
                key = (b, a)
            else:
                raise ValueError(
                    f"link_scales key {(a, b)} references unknown worker "
                    f"ids (prefill: {sorted(pids)}, decode: {sorted(dids)})")
            if key in out and out[key] != v:
                raise ValueError(f"conflicting link_scales for pair {key}: "
                                 f"{out[key]} vs {v}")
            out[key] = v
        return out

    # ------------------------------------------------------------ events
    def _at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def run(self, sim_reqs: list[SimRequest]) -> SimResults:
        self._n_expected = len(sim_reqs)
        for sr in sim_reqs:
            self._at(sr.arrival_s, lambda sr=sr: self._arrive(sr))
        if self.autoscaler is not None:
            self._at(self.cfg.autoscale_interval_s, self._autoscale_tick)
        while self._heap:
            self.now, _, fn = heapq.heappop(self._heap)
            fn()
        return SimResults(self.finished, self.rejected,
                          pulled_tokens=dict(self.pulled_tokens),
                          reused_tokens=dict(self.reused_tokens),
                          n_swapped=self.n_swapped,
                          n_sacrificed=self.n_sacrificed,
                          horizon_s=self.cfg.horizon_s)

    # -------------------------------------------------------- scheduling
    def _ctx(self, req: Request) -> RouteRequest:
        return RouteRequest(
            req.request_id, req.prompt_len,
            kv_bytes=req.prompt_len * self.cost.kv_bytes_per_token(),
            slo_class=req.slo_class, arrival_s=req.arrival_s,
            prefix_id=req.prefix_id,
        )

    def _link_scale(self, req: Request, decode_wid: str) -> float:
        if req.prefill_worker is None:
            return 1.0
        return self.link_scales.get((req.prefill_worker, decode_wid), 1.0)

    def _pair_cost(self, req: Request, decode_wid: str) -> tuple[float, float]:
        """(bandwidth scale, propagation latency) for the request's
        (prefill, decode) pair: from the bound topology when present,
        else the flat link_scales multiplier (zero latency)."""
        if self.topology is None or req.prefill_worker is None:
            return self._link_scale(req, decode_wid), 0.0
        ref_bw = self.cost.hw.link.bandwidth_Bps
        return (self.topology.pair_scale(req.prefill_worker, decode_wid, ref_bw),
                self.topology.pair_latency_s(req.prefill_worker, decode_wid))

    def _resident_tokens(self, req: Request, d: "_DecodeWorker") -> int:
        """Prefix tokens of ``req`` already resident on ``d`` — what a
        delta plan grafts instead of pulling."""
        if not self.cfg.delta_transfer or not req.prefix_id:
            return 0
        cached = d.prefix_cache.get(req.prefix_id, 0)
        plen = req.prefix_len or req.prompt_len
        return min(cached, plen, req.prompt_len)

    def _pair_transfer_s(self, req: Request, decode_wid: str) -> float:
        d = next(x for x in self.decodes if x.wid == decode_wid)
        suffix = req.prompt_len - self._resident_tokens(req, d)
        wire_scale = 0.5 if self.cfg.quantize_transfer else 1.0
        scale, latency_s = self._pair_cost(req, decode_wid)
        return latency_s + wire_scale * scale * self.cost.transfer_s(
            suffix, mode=self.cfg.transfer_mode,
            coalesce_factor=self.cfg.coalesce_factor)

    def _pair_layer_tail_s(self, req: Request, decode_wid: str) -> float:
        """Layer-streamed pull: delay from transfer start to the request
        becoming decodable (layer 0 landed; later layers hide behind the
        per-layer decode pipeline).  Delta/quantized transfer shrink the
        per-layer share the same way they shrink the whole pull."""
        d = next(x for x in self.decodes if x.wid == decode_wid)
        suffix = req.prompt_len - self._resident_tokens(req, d)
        wire_scale = 0.5 if self.cfg.quantize_transfer else 1.0
        scale, latency_s = self._pair_cost(req, decode_wid)
        # layer 0 cannot land before the first byte crosses the path, so
        # the propagation latency is part of the visible tail too
        return latency_s + wire_scale * scale * \
            self.cost.transfer_layer_tail_s(
                suffix, mode=self.cfg.transfer_mode,
                coalesce_factor=self.cfg.coalesce_factor)

    def _projected_ttft_s(self, req: Request) -> float:
        """Admission-time TTFT projection: mean backlog wait + own
        prefill.  Deliberately NO transfer term — measured TTFT is the
        first token, which this simulator emits at prefill completion
        (before the KV pull), and the projection must target the same
        definition or admission over-rejects."""
        own = self.cost.prefill_s(req.prompt_len)
        if self.cfg.mode == "colocated":
            backlog = sum(self.cost.prefill_s(r.prompt_len)
                          for d in self.decodes for r in d.kv_queue)
            return backlog / max(len(self.decodes), 1) + own
        backlog = sum(self.cost.prefill_s(r.prompt_len) for r in self.prefill_queue)
        busy = sum(max(0.0, w.busy_until - self.now) for w in self.prefills)
        return (busy + backlog) / max(len(self.prefills), 1) + own

    # ------------------------------------------------------- disagg flow
    def _arrive(self, sr: SimRequest) -> None:
        req = Request(sr.request_id, sr.prompt_len, sr.response_len, arrival_s=self.now,
                      prefix_id=sr.prefix_id, prefix_len=sr.prefix_len,
                      slo_class=sr.slo_class)
        self._meta[sr.request_id] = sr
        # Admission first, in EVERY mode (colocated must not silently
        # bypass the SLO controller).  Projection is O(queue); only pay
        # for it if the policy actually implements admission control.
        if type(self.policy).admit is not Policy.admit and \
                not self.policy.admit(self._ctx(req), self._projected_ttft_s(req)):
            req.to(RequestState.FAILED)  # SLO admission: reject up front
            self.rejected.append(req)
            return
        if self.cfg.mode == "colocated":
            self._co_arrive(req)
            return
        if self.cfg.mode == "push":
            # Fig. 10 step 1: the DECODE worker allocates blocks AT ARRIVAL,
            # before the prompt is even sent to the prefill worker.  This is
            # the held-but-idle memory of Motivation #3: while the request
            # waits for (and runs) prefill, its decode blocks serve nobody.
            self.push_admission.append(req)
            self._try_push_admissions()
            return
        self.prefill_queue.append(req)
        self._try_start_prefills()

    def _try_push_admissions(self) -> None:
        while self.push_admission:
            req = self.push_admission[0]
            # only offer workers that can actually hold the reservation —
            # a policy pick among non-fitting workers must not stall the
            # queue while another worker has room
            fitting = [d for d in self.decodes
                       if d.free_tokens() >= self._reserved_tokens(req)]
            if not fitting:
                break  # decode pools exhausted by reservations: admissions stall
            d = self._pick_decode(req, fitting)
            self.push_admission.pop(0)
            d.used_tokens += self._reserved_tokens(req)
            req.decode_worker = d.wid
            self.prefill_queue.append(req)
        # ALWAYS re-kick prefill: already-admitted requests may be waiting
        # for the worker even when the head admission stalls
        self._try_start_prefills()

    def _reserved_tokens(self, req: Request) -> int:
        extra = req.max_new_tokens if self.cfg.reserve_response else 0
        return req.prompt_len + extra

    def _pick_prefill(self, req: Request, cands: list[_PrefillWorker]) -> _PrefillWorker:
        chosen = self.policy.pick_prefill(self._ctx(req), [
            Candidate(w.wid,
                      free_units=w.cap_tokens - w.held_tokens,
                      total_units=w.cap_tokens,
                      ready_s=max(0.0, w.busy_until - self.now))
            for w in cands
        ])
        return next(w for w in cands if w.wid == chosen.worker_id)

    def _try_start_prefills(self) -> None:
        while self.prefill_queue:
            req = self.prefill_queue[0]
            cands = [w for w in self.prefills
                     if not w.draining and w.busy_until <= self.now
                     and w.held_tokens + req.prompt_len <= w.cap_tokens]
            if not cands:
                break  # every worker busy or HBM-full: wait
            w = self._pick_prefill(req, cands)
            self.prefill_queue.pop(0)
            req.prefill_worker = w.wid
            w.held_tokens += req.prompt_len
            req.to(RequestState.PREFILLING)
            req.prefill_start_s = self.now
            nominal = self.cost.prefill_s(req.prompt_len)
            dt = nominal * w.slowdown
            w.busy_until = self.now + dt
            self._at(w.busy_until, lambda req=req, w=w: self._prefill_done(req, w))
            if self.cfg.hedge_prefill:
                self._at(self.now + self.cfg.hedge_factor * nominal,
                         lambda req=req: self._maybe_hedge(req))

    def _maybe_hedge(self, req: Request) -> None:
        """Straggler mitigation: the prefill blew past hedge_factor × its
        nominal time — duplicate it on an idle, faster worker (first
        finisher wins; the loser's completion is ignored)."""
        if req.state is not RequestState.PREFILLING or req.prefill_end_s is not None:
            return
        cand = [w for w in self.prefills
                if not w.draining and w.busy_until <= self.now
                and w.wid != req.prefill_worker
                and w.held_tokens + req.prompt_len <= w.cap_tokens]
        if not cand:
            return
        w = min(cand, key=lambda w: w.slowdown)
        req.retries += 1
        w.held_tokens += req.prompt_len
        dt = self.cost.prefill_s(req.prompt_len) * w.slowdown
        w.busy_until = self.now + dt
        self._at(w.busy_until, lambda req=req, w=w: self._prefill_done(req, w))

    def _prefill_done(self, req: Request, w: _PrefillWorker) -> None:
        if req.prefill_end_s is not None:
            # a hedge twin already won; just release this copy's KV
            w.held_tokens -= req.prompt_len
            self._try_start_prefills()
            return
        req.prefill_worker = w.wid  # the winner owns the KV to pull from
        req.prefill_end_s = self.now
        if not req.token_times_s:
            # first token from prefill — a sacrificed request's replay
            # keeps its ORIGINAL first-token time (the stream paused,
            # it didn't restart from the caller's point of view)
            req.token_times_s.append(self.now)
        if self.cfg.mode == "push":
            # transfer overlapped layer-by-layer; visible tail ≈ 1 layer
            tail = self._pair_layer_tail_s(req, req.decode_worker)
            req.to(RequestState.KV_TRANSFER)
            req.transfer_start_s, req.transfer_end_s = self.now, self.now + tail
            w.held_tokens -= req.prompt_len
            self._at(req.transfer_end_s, lambda req=req: self._join_decode(req))
        else:
            req.to(RequestState.KV_QUEUED)
            # like the push path: don't offer exhausted workers to a
            # cost-first policy while another has room (fall back to all
            # when everyone is full — the request queues per §4.3)
            need = self._reserved_tokens(req)
            fitting = [x for x in self.decodes
                       if not x.draining and x.free_tokens() >= need]
            d = self._pick_decode(req, fitting or None)
            req.decode_worker = d.wid
            d.kv_queue.append(req)
            self._try_transfers(d, holder=w)
        self._try_start_prefills()

    def _pick_decode(self, req: Request,
                     cands: list[_DecodeWorker] | None = None) -> _DecodeWorker:
        if cands is None:
            # route around draining workers — unless that's everyone
            cands = [d for d in self.decodes if not d.draining] or self.decodes
        chosen = self.policy.pick_decode(self._ctx(req), [
            Candidate(d.wid,
                      free_units=d.free_tokens(),
                      total_units=d.cap_tokens,
                      queued_units=sum(r.prompt_len for r in d.kv_queue),
                      resident=len(d.active),
                      transfer_cost_s=self._pair_transfer_s(req, d.wid),
                      prefix_hit=1.0 if (req.prefix_id and
                                         req.prefix_id in d.prefix_cache)
                      else 0.0)
            for d in cands
        ])
        return next(d for d in cands if d.wid == chosen.worker_id)

    def _evict_sim_prefix(self, d: _DecodeWorker, keep: str | None) -> bool:
        """Drop the LRU retained prefix (except ``keep`` — a prefix being
        grafted right now stays resident, like the real worker's
        share-before-evict ordering); True if something was freed."""
        for pid in d.prefix_cache:
            if pid != keep:
                d.used_tokens -= d.prefix_cache.pop(pid)
                return True
        return False

    def _retain_sim_prefix(self, d: _DecodeWorker, req: Request, alloc: int) -> int:
        """On finish, keep the request's shared prefix resident for later
        delta admissions (the real worker's prefix retention).  Returns
        the token count carved out of the release; retained tokens stay
        in ``used_tokens`` until the LRU cap evicts them."""
        if (self.cfg.mode != "pull" or not self.cfg.delta_transfer
                or not req.prefix_id or self.cfg.prefix_cache_cap <= 0):
            return 0
        pid = req.prefix_id
        if pid in d.prefix_cache:
            d.prefix_cache[pid] = d.prefix_cache.pop(pid)  # LRU touch
            return 0  # already resident: the cache's copy owns those tokens
        ptoks = min(req.prefix_len or req.prompt_len, req.prompt_len, alloc)
        if ptoks <= 0:
            return 0
        d.prefix_cache[pid] = ptoks
        while len(d.prefix_cache) > self.cfg.prefix_cache_cap:
            evict = next(iter(d.prefix_cache))
            d.used_tokens -= d.prefix_cache.pop(evict)
        return ptoks

    def _try_transfers(self, d: _DecodeWorker, holder: _PrefillWorker | None = None) -> None:
        started = 0
        while d.kv_queue:
            if self.cfg.admission_batch and started >= self.cfg.admission_batch:
                return  # batch cap: the rest waits for the next opportunity
            req = d.kv_queue[0]
            while True:
                # delta plan: the resident prefix grafts for free, only
                # the suffix draws on the pool
                resident = self._resident_tokens(req, d)
                need = self._reserved_tokens(req) - resident
                if d.free_tokens() >= need:
                    break
                if self._evict_sim_prefix(d, keep=req.prefix_id):
                    continue
                # pool full even after prefix eviction: preempt a
                # resident (fleet mirror) or leave the request queued
                if not self._preempt_victim(d):
                    return
            if resident and req.prefix_id in d.prefix_cache:
                d.prefix_cache[req.prefix_id] = \
                    d.prefix_cache.pop(req.prefix_id)  # LRU touch
            d.kv_queue.pop(0)
            d.inflight_pulls += 1
            d.used_tokens += need
            self._alloc_tokens[req.request_id] = need
            self.reused_tokens[req.request_id] = \
                self.reused_tokens.get(req.request_id, 0) + resident
            self.pulled_tokens[req.request_id] = \
                self.pulled_tokens.get(req.request_id, 0) \
                + (req.prompt_len - resident)
            started += 1
            req.to(RequestState.KV_TRANSFER)
            dt = self._pair_transfer_s(req, d.wid)
            start = max(self.now, d.nic_free_at)
            if self.cfg.transfer_overlap == "blocking" and d.iterating:
                # the synchronous engine can't post reads mid-iteration:
                # the worker thread is in the decode step
                start = max(start, d.iter_end)
            d.nic_free_at = start + dt
            if self.cfg.transfer_overlap == "blocking":
                # ...and once it enters drain() it is stuck there
                d.pull_busy_until = max(d.pull_busy_until, start + dt)
            req.transfer_start_s, req.transfer_end_s = start, start + dt
            w = next(p for p in self.prefills if p.wid == req.prefill_worker)
            self._at(start + dt, lambda req=req, w=w: self._transfer_done(req, w))
            if self.cfg.transfer_overlap == "layerwise":
                # layer-streamed consumption: decodable once layer 0 lands
                join_at = start + min(dt, self._pair_layer_tail_s(req, d.wid))
                self._at(join_at, lambda req=req: self._join_decode(req))

    def _transfer_done(self, req: Request, w: _PrefillWorker) -> None:
        # COMPLETE(): prefill frees its copy
        w.held_tokens -= req.prompt_len
        self._try_start_prefills()
        d = next(x for x in self.decodes if x.wid == req.decode_worker)
        d.inflight_pulls -= 1
        if self.cfg.transfer_overlap != "layerwise":
            self._join_decode(req)  # layerwise mode joined at layer 0
        self._try_transfers(d)  # NIC freed: admit the next batch
        self._try_swap_in(d)

    def _join_decode(self, req: Request) -> None:
        d = next(x for x in self.decodes if x.wid == req.decode_worker)
        req.to(RequestState.QUEUED_DECODE)
        if self.cfg.batching == "round":
            # round-synchronous cohorts: a round in progress is frozen —
            # the request waits for the whole cohort to drain
            d.round_wait.append(req)
            if not d.iterating:
                self._start_round(d)
            return
        d.active.append(req)
        req.to(RequestState.DECODING)
        req.decode_start_s = self.now
        if not d.iterating:
            self._schedule_iteration(d)

    def _start_round(self, d: _DecodeWorker) -> None:
        """Round batching: freeze the next cohort (capped at the batch
        limit; the rest waits for the round after)."""
        cohort = d.round_wait[: self.cfg.max_decode_batch]
        del d.round_wait[: len(cohort)]
        for r in cohort:
            r.to(RequestState.DECODING)
            r.decode_start_s = self.now
            d.active.append(r)
        self._schedule_iteration(d)

    def _schedule_iteration(self, d: _DecodeWorker) -> None:
        batch = [r for r in d.active if r.tokens_generated < r.max_new_tokens - 1]
        if not batch:
            if self.cfg.batching == "round" and d.round_wait:
                self._start_round(d)  # cohort drained: admit the next one
                return
            d.iterating = False
            return
        d.iterating = True
        start = self.now
        if self.cfg.transfer_overlap == "blocking":
            # synchronous engine: the worker is in drain() until the pull
            # finishes — decode iterations can't start underneath it
            start = max(start, d.pull_busy_until)
        batch = batch[: self.cfg.max_decode_batch]
        active_tokens = sum(r.prompt_len + r.tokens_generated for r in batch)
        dt = self.cost.decode_step_s(active_tokens, len(batch)) * d.slowdown
        d.iter_end = start + dt
        self._at(start + dt, lambda d=d, batch=batch: self._iteration_done(d, batch))

    def _iteration_done(self, d: _DecodeWorker, batch: list[Request]) -> None:
        for r in batch:
            if r not in d.active:
                continue  # preempted (swapped/sacrificed) mid-iteration
            r.tokens_generated += 1
            r.token_times_s.append(self.now)
            if not self.cfg.reserve_response:
                d.used_tokens += 1
            if r.tokens_generated >= r.max_new_tokens - 1:
                r.done_s = self.now
                r.to(RequestState.DONE)
                d.active.remove(r)
                alloc = self._alloc_tokens.pop(r.request_id, None)
                if alloc is None:  # push path: full reservation was charged
                    alloc = self._reserved_tokens(r) if self.cfg.reserve_response \
                        else (r.prompt_len + r.tokens_generated)
                elif not self.cfg.reserve_response:
                    alloc += r.tokens_generated  # per-token growth charged above
                d.used_tokens -= alloc - self._retain_sim_prefix(d, r, alloc)
                self.finished.append(r)
        if self.cfg.mode == "pull":
            self._try_transfers(d)
            self._try_swap_in(d)
        elif self.cfg.mode == "push":
            self._try_push_admissions()  # freed KV unblocks stalled arrivals
        self._schedule_iteration(d)

    # ------------------------------------------- fleet mirror (preemption)
    def _preempt_victim(self, d: _DecodeWorker) -> bool:
        """Memory-pressure preemption, mirroring ``fleet.MemoryGovernor``:
        free a resident decode by swap-out (host memory, resumed later)
        or sacrifice (drop KV, truncate-and-replay through prefill).
        Returns True if tokens were freed."""
        cfg = self.cfg
        if cfg.preemption == "none" or not d.active:
            return False
        if d.used_tokens / max(d.cap_tokens, 1) < cfg.preempt_high:
            return False  # pressure below the trigger: let the pull queue
        # anti-thrash eligibility: a bounded number of preemptions per
        # request, and never re-preempt before the victim made progress
        eligible = [
            r for r in d.active
            if self._preempt_count.get(r.request_id, 0) < cfg.max_preemptions
            and r.tokens_generated > self._tok_at_preempt.get(r.request_id, -1)
        ]
        if not eligible:
            return False
        if cfg.victim_policy == "fifo":
            r = eligible[0]           # oldest resident: earliest to rejoin
        elif cfg.victim_policy == "priority":
            # lowest SLO class first; ties broken LIFO (newest resident)
            r = max(enumerate(eligible),
                    key=lambda p: (DEFAULT_CLASS_RANK.get(p[1].slo_class, 1),
                                   p[0]))[1]
        else:  # lifo — newest resident has the least sunk decode work
            r = eligible[-1]
        rid = r.request_id
        self._preempt_count[rid] = self._preempt_count.get(rid, 0) + 1
        self._tok_at_preempt[rid] = r.tokens_generated
        d.active.remove(r)
        base = self._alloc_tokens.pop(rid, 0)
        freed = base + (0 if cfg.reserve_response else r.tokens_generated)
        d.used_tokens -= freed
        if cfg.preemption == "swap":
            d.swapped.append((r, base))  # KV parked host-side, state kept
            self.n_swapped += 1
            return True
        # sacrifice: drop the KV and replay through prefill.  The caller's
        # stream pauses and resumes (decode is deterministic), so the
        # ORIGINAL first-token time survives — only later tokens re-emit.
        r.retries += 1
        r.tokens_generated = 0
        r.prefill_end_s = None
        r.transfer_start_s = r.transfer_end_s = None
        r.decode_start_s = None
        r.decode_worker = None
        del r.token_times_s[1:]
        r.to(RequestState.FAILED)
        r.to(RequestState.QUEUED_PREFILL)
        self.prefill_queue.append(r)
        self.n_sacrificed += 1
        self._at(self.now, lambda: self._try_start_prefills())
        return True

    def _try_swap_in(self, d: _DecodeWorker) -> None:
        """Resume swapped-out requests (oldest first) once the pressure
        that evicted them has cleared — never while pulls are still
        queued (resuming under a waiting pull re-triggers the squeeze)."""
        while d.swapped and not d.kv_queue:
            r, base = d.swapped[0]
            need = base + (0 if self.cfg.reserve_response else r.tokens_generated)
            if d.free_tokens() < need:
                return
            d.swapped.pop(0)
            d.used_tokens += need
            self._alloc_tokens[r.request_id] = base
            # swap-in cost: the full KV footprint re-crosses host<->device,
            # cheaper than a network pull by swap_cost_scale
            dt = self.cfg.swap_cost_scale * self.cost.transfer_s(
                r.prompt_len + r.tokens_generated,
                mode=self.cfg.transfer_mode,
                coalesce_factor=self.cfg.coalesce_factor)
            self._at(self.now + dt, lambda r=r, d=d: self._swap_rejoin(d, r))

    def _swap_rejoin(self, d: _DecodeWorker, r: Request) -> None:
        d.active.append(r)
        if not d.iterating:
            self._schedule_iteration(d)

    # ------------------------------------------- fleet mirror (autoscale)
    def _autoscale_tick(self) -> None:
        """Periodic fleet evaluation: feed the REAL ``fleet.Autoscaler``
        LoadReports built from sim worker state (tokens-as-blocks,
        block_size=1) and apply its add/drain plan."""
        p_reports = {
            w.wid: LoadReport(w.wid, "prefill",
                              free_blocks=max(0, w.cap_tokens - w.held_tokens),
                              total_blocks=w.cap_tokens, block_size=1,
                              t=self.now)
            for w in self.prefills}
        d_reports = {
            d.wid: LoadReport(d.wid, "decode",
                              free_blocks=d.free_tokens(),
                              total_blocks=d.cap_tokens,
                              queued_tokens=sum(r.prompt_len
                                                for r in d.kv_queue),
                              block_size=1, t=self.now)
            for d in self.decodes}
        draining = {w.wid: "prefill" for w in self.prefills if w.draining}
        draining.update({d.wid: "decode" for d in self.decodes if d.draining})
        for act in self.autoscaler.plan(p_reports, d_reports,
                                        dispatch_backlog=len(self.prefill_queue),
                                        draining=draining):
            if act[0] == "add" and act[1] == "prefill":
                if self.topology is None or self.topology.has_spare("prefill"):
                    self.prefills.append(self._new_prefill(f"p{next(self._wid_p)}"))
            elif act[0] == "add":
                if self.topology is None or self.topology.has_spare("decode"):
                    self.decodes.append(self._new_decode(f"d{next(self._wid_d)}"))
            elif act[1] == "prefill":
                next(x for x in self.prefills if x.wid == act[2]).draining = True
            else:
                dw = next(x for x in self.decodes if x.wid == act[2])
                dw.draining = True
                # reassign queued pulls onto live workers that fit them;
                # what doesn't fit stays and drains out normally
                for r in list(dw.kv_queue):
                    need = self._reserved_tokens(r)
                    fitting = [x for x in self.decodes
                               if not x.draining and x.free_tokens() >= need]
                    if not fitting:
                        break
                    dw.kv_queue.remove(r)
                    tgt = self._pick_decode(r, fitting)
                    r.decode_worker = tgt.wid
                    tgt.kv_queue.append(r)
                    self._try_transfers(tgt)
        # advance drains: retire workers that have gone quiet (their
        # machines return to the topology's spare pool)
        retire_p = [w for w in self.prefills
                    if w.draining and w.held_tokens <= 0
                    and w.busy_until <= self.now]
        retire_d = [d for d in self.decodes
                    if d.draining and not d.active and not d.kv_queue
                    and not d.round_wait and not d.swapped
                    and not d.inflight_pulls]
        if self.topology is not None:
            for w in retire_p + retire_d:
                self.topology.release_worker(w.wid)
        self.prefills = [w for w in self.prefills if w not in retire_p]
        self.decodes = [d for d in self.decodes if d not in retire_d]
        self._try_start_prefills()  # hot-added capacity admits immediately
        if len(self.finished) + len(self.rejected) < self._n_expected:
            self._at(self.now + self.cfg.autoscale_interval_s,
                     self._autoscale_tick)

    # --------------------------------------------------- colocated (vLLM)
    def _co_arrive(self, req: Request) -> None:
        d = self._pick_decode(req)
        req.decode_worker = d.wid
        d.kv_queue.append(req)
        if not d.iterating:
            self._co_step(d)

    def _co_step(self, d: _DecodeWorker) -> None:
        """One scheduler iteration: prefill-prioritized (vLLM default)."""
        # admit a prefill if one fits
        if d.kv_queue:
            req = d.kv_queue[0]
            if d.free_tokens() >= self._reserved_tokens(req):
                d.kv_queue.pop(0)
                d.used_tokens += self._reserved_tokens(req)
                req.to(RequestState.PREFILLING)
                req.prefill_start_s = self.now
                d.iterating = True
                dt = self.cost.prefill_s(req.prompt_len)
                # the prefill stalls every resident decode for `dt`

                def done(req=req, d=d):
                    req.prefill_end_s = self.now
                    req.token_times_s.append(self.now)
                    req.to(RequestState.KV_TRANSFER)  # zero-cost local handoff
                    req.transfer_start_s = req.transfer_end_s = self.now
                    req.to(RequestState.QUEUED_DECODE)
                    d.active.append(req)
                    req.to(RequestState.DECODING)
                    req.decode_start_s = self.now
                    self._co_step(d)

                self._at(self.now + dt, done)
                return
        # otherwise run one decode iteration
        batch = [r for r in d.active if r.tokens_generated < r.max_new_tokens - 1]
        if not batch:
            d.iterating = False
            return
        d.iterating = True
        batch = batch[: self.cfg.max_decode_batch]
        active_tokens = sum(r.prompt_len + r.tokens_generated for r in batch)
        dt = self.cost.decode_step_s(active_tokens, len(batch))

        def iter_done(d=d, batch=batch):
            for r in batch:
                r.tokens_generated += 1
                r.token_times_s.append(self.now)
                if r.tokens_generated >= r.max_new_tokens - 1:
                    r.done_s = self.now
                    r.to(RequestState.DONE)
                    d.active.remove(r)
                    d.used_tokens -= self._reserved_tokens(r)
                    self.finished.append(r)
            self._co_step(d)

        self._at(self.now + dt, iter_done)
