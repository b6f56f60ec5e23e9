"""The KVDirect communication engine (§4.2).

A transaction queue drained into one-sided reads plus ACK-serialized
COMPLETE messages.  Two *modes* reproduce the paper's comparison:

* ``tensor_centric`` (KVDirect): the decode worker computes every remote
  offset from the connection-time ``TensorDesc`` and posts one-sided reads
  directly — zero remote-side work per block, coalescing across requests.
* ``message`` (the NCCL/UCX/MSCCL++ strawman of Fig. 3/7a): per round,
  a metadata RPC, a gather "kernel" into a bounded staging buffer, a
  buffer send, a scatter "kernel" on the receiver, and a notify — with
  real double-copies when the memcpy backend is active.

Two *backends* separate mechanism from timing:

* ``memcpy``  — actually moves bytes between worker address spaces
  (torch slabs on the workers' devices).  This is what the correctness
  tests and Fig. 15 measurements use; a traced engine records each pull's
  wall time as a ``pull`` span.
* ``timed``   — additionally accrues a modeled clock from ``LinkModel``
  (per-verb post overhead, RPC latency, kernel-launch/sync costs from the
  paper's Fig. 3 breakdown, link bandwidth).  The event simulator and the
  Fig. 3/4 reproductions read this clock.

Both run together: memcpy gives ground-truth bytes, timed gives the
latency the same schedule would cost on the paper's hardware.

Port of ``src/repro/core/transfer_engine.py``.  What differs: a
``MemoryRegion`` is a torch ``uint8`` slab on the worker's device, cut
into pages of ``page_nbytes`` (one K or V span of a KV block), and the
tensor-centric data path lands each tick's coalesced reads with ONE
``kv_pull`` launch per (source, destination) region pair — the merged
reads become page-id pairs.  A read off those pages (a region registered
without ``page_nbytes``, two regions of different page sizes, or a span
that starts or ends inside a page) lands through its own ``kv_pull``
launch as one page of its own length, so every span the reference's
byte copy lands, the port lands, byte for byte.  Reads carrying an int8
``qscale`` are quantized on the device and land through
``kv_pull_dequant`` the same two ways, with the reference's arithmetic
(f32 divide, round half to even, clip ±127, int8, f32 product, one cast
to bf16).  The message mode stays a plain byte copy.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterable, Sequence

import torch

from repro_torch.core.coalesce import CoalescedRead, coalesce
from repro_torch.core.descriptors import ByteRange, CompleteTxn, ReadTxn, Txn
from repro_torch.kernels.kv_pull.ops import kv_pull, kv_pull_dequant
from repro_torch.obs.trace import NULL_TRACER

__all__ = [
    "KVDIRECT_UTIL",
    "LinkModel",
    "TransferStats",
    "MemoryRegion",
    "TransferEngine",
    "TransferFuture",
    "ConnectionTornError",
]

# Paper Fig. 15: KVDirect sustains 22.23 GB/s of a 400 Gbps link ≈ 44.5 %
# effective utilization.  Single source of truth — the simulator's cost
# model and the router's transfer scores both reference it.
KVDIRECT_UTIL = 0.445


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Timing constants.  Defaults reproduce the paper's environment:
    400 Gbps RDMA NIC (50 GB/s), Fig. 3's measured per-step costs for the
    message-passing baseline, and a ~2 µs verb-post overhead for RDMA.

    For the TPU adaptation, construct with ``ici()`` — one-sided remote
    DMA over a 50 GB/s ICI link with a ~1 µs descriptor-post overhead —
    or ``dcn()`` for the cross-pod path.
    """

    bandwidth_Bps: float = 50e9          # 400 Gbps NIC
    post_overhead_s: float = 2e-6        # posting one RDMA verb
    # One-way propagation delay of the path (0 for a rack-local link;
    # tens of ms for a cross-region hop).  Charged ONCE per logical
    # pull by the router's ``modeled_transfer_s`` and the simulator's
    # pair costs — not per read, since in-flight reads pipeline and only
    # the first byte pays the propagation latency.
    latency_s: float = 0.0
    rpc_latency_s: float = 1.0e-3        # Fig. 3 step 1: metadata RPC
    gather_launch_s: float = 3.25e-3     # Fig. 3 step 2: gather kernel + copy to buffer
    cpu_sync_s: float = 1.3e-3           # Fig. 3 step 3: GPU sync + NIC op (fixed part)
    scatter_launch_s: float = 3.31e-3    # Fig. 3 step 4: scatter kernel
    notify_s: float = 1.0e-3             # Fig. 3 step 6: completion notify
    ack_rtt_s: float = 8e-6              # COMPLETE/ACK round trip (one-sided write + ack)
    # Streaming message-passing (UCX) per-block CPU overhead.  4.4 µs
    # reproduces the paper's whole Fig. 4 utilization curve on a 400 Gbps
    # link: util(4 KB) = wire/(wire+4.4 µs) = 1.8 %, util(32 KB) = 13 %.
    message_block_overhead_s: float = 4.4e-6

    @staticmethod
    def nic_400g() -> "LinkModel":
        return LinkModel()

    @staticmethod
    def ici() -> "LinkModel":
        """TPU v5e ICI link: ~50 GB/s, on-chip DMA descriptor post ~1 µs."""
        return LinkModel(bandwidth_Bps=50e9, post_overhead_s=1e-6, ack_rtt_s=4e-6)

    @staticmethod
    def dcn() -> "LinkModel":
        """Cross-pod data-center network: ~25 GB/s effective per host link."""
        return LinkModel(bandwidth_Bps=25e9, post_overhead_s=3e-6, ack_rtt_s=2e-5)

    def read_time(self, nbytes: int) -> float:
        return self.post_overhead_s + nbytes / self.bandwidth_Bps

    def message_round_time(self, nbytes: int) -> float:
        """One NAIVE per-block round (Fig. 3's RPC flow, nothing
        overlapped) — the strawman timeline of Motivation #1."""
        return (
            self.rpc_latency_s
            + self.gather_launch_s
            + self.cpu_sync_s
            + nbytes / self.bandwidth_Bps
            + self.scatter_launch_s
            + self.notify_s
        )

    def message_stream_time(self, nbytes: int, n_blocks: int) -> float:
        """A PIPELINED stream of message sends (UCX-style, Fig. 4): the
        per-block CPU overhead is what bounds throughput."""
        return n_blocks * self.message_block_overhead_s + nbytes / self.bandwidth_Bps


@dataclasses.dataclass
class TransferStats:
    bytes_moved: int = 0
    reads_posted: int = 0           # RDMA-level ops after coalescing
    txns_submitted: int = 0         # original read transactions
    completes: int = 0
    modeled_time_s: float = 0.0     # LinkModel clock
    rounds: int = 0                 # message-mode staging rounds

    @property
    def coalesce_factor(self) -> float:
        return self.txns_submitted / self.reads_posted if self.reads_posted else 1.0

    def modeled_bandwidth_Bps(self) -> float:
        return self.bytes_moved / self.modeled_time_s if self.modeled_time_s else 0.0


@dataclasses.dataclass
class _PullTrace:
    """A traced pull in flight: when it was submitted, the request's
    landed bytes then (a retry's count starts from them), the last layer's
    end, and its read transactions and ``progress`` calls so far."""

    t0: float
    bytes0: int
    mark: float
    txns: int = 0
    pumps: int = 0
    last_call: int = -1


class ConnectionTornError(KeyError):
    """An MR was torn down (or never registered) while transactions
    referencing it were still in flight.  Subclasses ``KeyError`` for
    backward compatibility with callers that caught the engine's old bare
    ``KeyError``; carries the torn worker and the affected request ids so
    the serving layer can park / re-route those requests cleanly."""

    def __init__(self, worker_id: str, request_ids: Sequence[str]) -> None:
        self.worker_id = worker_id
        self.request_ids = tuple(request_ids)
        super().__init__(
            f"unregistered worker {worker_id!r} with transactions in flight "
            f"for requests {self.request_ids} (connection torn down?)"
        )

    def __str__(self) -> str:  # KeyError.__str__ repr-quotes; keep it readable
        return self.args[0]


class TransferFuture:
    """Completion handle for one request's in-flight transfer.

    Resolves when the request's COMPLETE executes (success) or when an MR
    it depends on is torn down mid-transfer (failure, ``exception()`` is a
    ``ConnectionTornError``).  ``layers_done`` exposes layer-streamed
    progress: a layer index appears as soon as every read tagged with it
    has executed, so layer-0 KV is observable before the pull finishes.

    ``wait_layer(i)`` is the pipelined consumer's primitive: it advances
    the owning engine until layer ``i``'s bytes are resident (or the
    transfer dies), so a decode step can run layer ``i``'s attention
    while layers ``i+1..L-1`` are still in flight.  ``add_layer_callback``
    is the event-driven form of the same signal.
    """

    __slots__ = ("request_id", "_resolved", "_error", "_layers_done", "_cbs",
                 "_layer_cbs", "_engine")

    def __init__(self, request_id: str, engine: "TransferEngine | None" = None) -> None:
        self.request_id = request_id
        self._resolved = False
        self._error: Exception | None = None
        self._layers_done: list[int] = []
        self._cbs: list[Callable[["TransferFuture"], None]] = []
        self._layer_cbs: list[Callable[["TransferFuture", int], None]] = []
        self._engine = engine

    def done(self) -> bool:
        return self._resolved

    @property
    def failed(self) -> bool:
        return self._resolved and self._error is not None

    def exception(self) -> Exception | None:
        return self._error

    @property
    def layers_done(self) -> tuple[int, ...]:
        return tuple(self._layers_done)

    def layer_done(self, layer: int) -> bool:
        return layer in self._layers_done

    def wait_layer(self, layer: int, *, budget: int | None = 32) -> None:
        """Advance the owning engine until every read tagged ``layer`` has
        executed.  Progresses ``budget`` transactions at a time (None =
        run the queue dry) so foreign work interleaves fairly.  Raises the
        transfer's error if it dies first (``ConnectionTornError`` on a
        mid-pull teardown — possibly BETWEEN layers, which is exactly the
        window the layerwise decode consumer must survive), and
        ``RuntimeError`` if the engine's queue empties without the layer
        completing (the pull was never layer-tagged, or the layer index is
        out of range)."""
        budget = None if budget is None else max(1, budget)
        while not self._resolved and layer not in self._layers_done:
            if self._engine is None or not self._engine.pending:
                raise RuntimeError(
                    f"transfer of {self.request_id!r} cannot reach layer {layer}: "
                    "engine queue is empty (untagged pull or bad layer index?)"
                )
            self._engine.progress(budget)
        if self._error is not None:
            raise self._error
        if layer not in self._layers_done:
            raise RuntimeError(
                f"transfer of {self.request_id!r} completed without layer {layer} "
                "(untagged pull or bad layer index?)"
            )

    def add_layer_callback(self, cb: Callable[["TransferFuture", int], None]) -> None:
        """``cb(future, layer)`` fires when a layer's reads all execute;
        fires immediately for layers already done."""
        for layer in list(self._layers_done):
            cb(self, layer)
        if not self._resolved:
            self._layer_cbs.append(cb)

    def result(self) -> str:
        """The request id, or raises the transfer's error.  Raises
        ``RuntimeError`` if the transfer is still in flight (call
        ``progress()``/``drain()`` first — there is no blocking wait)."""
        if not self._resolved:
            raise RuntimeError(f"transfer of {self.request_id!r} still in flight")
        if self._error is not None:
            raise self._error
        return self.request_id

    def add_done_callback(self, cb: Callable[["TransferFuture"], None]) -> None:
        if self._resolved:
            cb(self)
        else:
            self._cbs.append(cb)

    def __repr__(self) -> str:
        state = ("failed" if self.failed else "done") if self._resolved else "pending"
        return f"TransferFuture({self.request_id!r}, {state}, layers={self._layers_done})"


@dataclasses.dataclass
class MemoryRegion:
    """A registered MR: a worker's slab of device memory the engine may
    touch.  ``page_nbytes`` is the unit the kv_pull kernel moves (a KV
    cache registers its block span); 0 means the region takes only the
    message mode's byte copies."""

    worker_id: str
    base_address: int
    buffer: torch.Tensor  # dtype uint8, 1-D
    page_nbytes: int = 0

    def view(self, rng: ByteRange) -> torch.Tensor:
        lo = rng.offset - self.base_address
        if lo < 0 or lo + rng.nbytes > self.buffer.numel():
            raise IndexError(
                f"range {rng} outside MR of {self.worker_id} "
                f"(base={self.base_address:#x} size={self.buffer.numel()})"
            )
        return self.buffer[lo : lo + rng.nbytes]

    def pages(self, rng: ByteRange) -> range | None:
        """Page ids a page-aligned range covers; None for a span off the
        region's pages (or a region without pages)."""
        self.view(rng)  # bounds check
        lo = rng.offset - self.base_address
        p = self.page_nbytes
        if p <= 0 or lo % p or rng.nbytes % p:
            return None
        return range(lo // p, (lo + rng.nbytes) // p)

    def page_array(self, dtype: torch.dtype = torch.uint8) -> torch.Tensor:
        """The slab as ``[n_pages, page_nbytes / itemsize]`` of ``dtype``."""
        n = self.buffer.numel() // self.page_nbytes
        return self.buffer[: n * self.page_nbytes].view(dtype).view(n, -1)


class TransferEngine:
    """Event-driven transaction queue drained into coalesced one-sided reads.

    The engine is incremental: ``submit()`` returns a ``TransferFuture``
    per request, ``progress(budget)`` executes up to ``budget`` queued
    transactions (so a decode worker can interleave transfer work with
    decode compute), ``poll()`` drains the completion queue of futures
    that resolved since the last poll, and ``drain()`` is simply
    progress-until-empty for legacy blocking callers — byte movement is
    identical either way.

    Ordering rules (§4.2):
      * reads are asynchronous and may complete out of order ACROSS
        requests;
      * a COMPLETE for request R is only executed after every read of R
        already in the queue has executed (the decode worker enqueues
        COMPLETE after TRANSFERs, and the engine's coalescing window
        stops at the first COMPLETE, preserving this);
      * COMPLETEs on one connection are serialized by an ACK so a later
        COMPLETE cannot overwrite an unconsumed mailbox slot (WAW).
        Reads are never blocked by a pending ACK.

    Teardown during transfer: ``deregister_memory`` drops every queued
    transaction touching the torn MR and fails the affected requests'
    futures with ``ConnectionTornError`` (instead of surfacing a bare
    ``KeyError`` later in ``_land``), so the serving layer can re-route.
    """

    def __init__(
        self,
        *,
        mode: str = "tensor_centric",
        coalescing: str = "fifo",
        link: LinkModel | None = None,
        execute_copies: bool = True,
        staging_blocks: int = 2,
        staging_block_bytes: int = 256 * 1024,
        codec: str = "none",
        tick_budget: int = 64,
        tracer=None,
        metrics=None,
    ) -> None:
        """codec="int8_transport": beyond-paper KV compression on the wire
        (the paper lists KV compression as complementary, §6) — bf16 spans
        are symmetric-quantized to int8 + one f32 scale per read, halving
        wire bytes; the destination slab is dequantized bf16, so compute
        is unchanged.  Lossy (≤1/127 of the span max; tests bound it)."""
        if mode not in ("tensor_centric", "message"):
            raise ValueError(f"unknown mode {mode!r}")
        if codec not in ("none", "int8_transport"):
            raise ValueError(f"unknown codec {codec!r}")
        self.mode = mode
        self.codec = codec
        self.coalescing = coalescing if mode == "tensor_centric" else "none"
        self.link = link or LinkModel()
        self.execute_copies = execute_copies
        # Message-mode staging buffer capacity (Fig. 7a: "can hold two blocks").
        self.staging_bytes = staging_blocks * staging_block_bytes
        self._regions: dict[str, MemoryRegion] = {}
        self._queue: collections.deque[Txn] = collections.deque()
        self._outstanding_reads: collections.Counter[str] = collections.Counter()
        self._outstanding_layer: collections.Counter[tuple[str, int]] = collections.Counter()
        self._futures: dict[str, TransferFuture] = {}  # unresolved, by request
        # Completion notifications are a convenience view — the futures
        # themselves carry the resolved state — so the queue is bounded:
        # blocking callers that never poll() must not leak one entry per
        # request served over a long-lived engine.
        self._completions: collections.deque[TransferFuture] = collections.deque(
            maxlen=4096)
        # Requests torn mid-execution whose CompleteTxn is still queued:
        # that COMPLETE must be swallowed, not executed — the bytes never
        # fully landed, so completion callbacks (prefill-side free!) must
        # not fire for it.
        self._torn_completes: set[str] = set()
        self._complete_cbs: list[Callable[[CompleteTxn], None]] = []
        # Per-request bytes actually landed (executed reads, retries
        # accumulate).  Entries live until pulled_bytes(pop=True) — the
        # serving layer pops them into the request handle at completion.
        self._pulled_bytes: collections.Counter[str] = collections.Counter()
        # Per-request bytes NOT moved because the destination already held
        # them (delta transfer plans grafting resident prefix / dedup'd
        # blocks).  Same lifecycle as _pulled_bytes: retries accumulate,
        # popped at request completion.
        self._reused_bytes: collections.Counter[str] = collections.Counter()
        self.tick_budget = tick_budget
        self.stats = TransferStats()
        # Observability (optional; see docs/observability.md): the tracer
        # records each request's pull on the request's track — one span
        # per layer as its reads land, and one ``pull`` span from the
        # first submit to the resolution — so a serve trace shows the
        # wire timeline under the decode timeline.  The metrics registry
        # accumulates engine totals (bytes, reads, completes, teardowns).
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self._pulls: dict[str, _PullTrace] = {}  # traced pulls in flight
        self._progress_calls = 0

    # ------------------------------------------------------------- setup
    def register_memory(self, region: MemoryRegion) -> None:
        if region.worker_id in self._regions:
            raise ValueError(f"worker {region.worker_id!r} already registered an MR")
        # The engine models ONE flat address space (descriptors carry raw
        # addresses, §4.1) — two slabs sharing addresses would make a
        # descriptor ambiguous, so MRs must be disjoint.
        lo, hi = region.base_address, region.base_address + region.buffer.numel()
        for other in self._regions.values():
            o_lo, o_hi = other.base_address, other.base_address + other.buffer.numel()
            if lo < o_hi and o_lo < hi:
                raise ValueError(
                    f"MR of {region.worker_id!r} [{lo:#x}, {hi:#x}) overlaps "
                    f"MR of {other.worker_id!r} [{o_lo:#x}, {o_hi:#x})"
                )
        self._regions[region.worker_id] = region

    def deregister_memory(self, worker_id: str) -> None:
        """Tear down a worker's MR.  Queued transactions that reference it
        are dropped and the affected requests' futures fail with
        ``ConnectionTornError`` — a crash mid-pull becomes a typed, per-
        request failure the serving layer can re-route, not a late
        ``KeyError`` deep in ``_land``."""
        self._regions.pop(worker_id, None)
        if not self._queue:
            return
        survivors: collections.deque[Txn] = collections.deque()
        torn: list[Txn] = []
        for t in self._queue:
            if t.src_worker == worker_id or t.dst_worker == worker_id:
                torn.append(t)
            else:
                survivors.append(t)
        if not torn:
            return
        self._queue = survivors
        torn_rids: dict[str, None] = {}  # ordered set
        for t in torn:
            torn_rids[t.request_id] = None
            if isinstance(t, ReadTxn):
                self._outstanding_reads[t.request_id] -= 1
                if t.layer is not None:
                    key = (t.request_id, t.layer)
                    self._outstanding_layer[key] -= 1
                    if self._outstanding_layer[key] <= 0:
                        del self._outstanding_layer[key]  # dropped, NOT done
            else:
                # its COMPLETE was dropped with the reads: a future re-pull
                # under the same request id must not have ITS complete
                # swallowed by a stale torn marker
                self._torn_completes.discard(t.request_id)
        for rid in torn_rids:
            fut = self._futures.get(rid)
            if fut is not None:
                self._resolve(fut, ConnectionTornError(worker_id, (rid,)))

    def on_complete(self, cb: Callable[[CompleteTxn], None]) -> None:
        self._complete_cbs.append(cb)

    # ------------------------------------------------------------ submit
    def submit(self, txns: Iterable[Txn]) -> list[TransferFuture]:
        """Enqueue transactions; returns the futures newly created by this
        call (one per request id not already in flight).  Existing callers
        that ignore the return value are unaffected."""
        created: list[TransferFuture] = []
        for t in txns:
            if isinstance(t, ReadTxn):
                self._outstanding_reads[t.request_id] += 1
                if t.layer is not None:
                    self._outstanding_layer[(t.request_id, t.layer)] += 1
                self.stats.txns_submitted += 1
            if t.request_id not in self._futures:
                fut = TransferFuture(t.request_id, engine=self)
                self._futures[t.request_id] = fut
                created.append(fut)
                if self.tracer.enabled:
                    now = self.tracer.now()
                    self._pulls[t.request_id] = _PullTrace(
                        now, self._pulled_bytes.get(t.request_id, 0), now)
                if self.metrics is not None:
                    self.metrics.inc("engine.pulls_submitted")
            self._queue.append(t)
        return created

    def future(self, request_id: str) -> TransferFuture | None:
        """The unresolved future for ``request_id``, if any."""
        return self._futures.get(request_id)

    @property
    def pending(self) -> int:
        """Queued transactions not yet executed."""
        return len(self._queue)

    # ----------------------------------------------------------- resolve
    def _resolve(self, fut: TransferFuture, error: Exception | None = None) -> None:
        fut._resolved = True
        fut._error = error
        self._futures.pop(fut.request_id, None)
        self._completions.append(fut)
        pull = self._pulls.pop(fut.request_id, None)
        if pull is not None:
            rid = fut.request_id
            self.tracer.complete(
                "pull", ("request", rid), pull.t0, self.tracer.now(),
                txns=pull.txns, pumps=pull.pumps, torn=error is not None,
                bytes=self._pulled_bytes.get(rid, 0) - pull.bytes0)
        if self.metrics is not None and error is not None:
            self.metrics.inc("engine.pulls_torn")
        for cb in fut._cbs:
            cb(fut)
        fut._cbs.clear()
        fut._layer_cbs.clear()

    def poll(self) -> list[TransferFuture]:
        """Futures resolved (success or failure) since the last poll."""
        out = list(self._completions)
        self._completions.clear()
        return out

    # ---------------------------------------------------------- progress
    def progress(self, budget: int | None = None) -> int:
        """Execute up to ``budget`` queued transactions (all of them when
        ``budget`` is None) and return how many were processed.  This is
        the incremental heart of the engine: a decode worker calls it
        between decode steps so transfer time hides behind compute.

        A budget may split what would have been one coalescing window —
        bytes moved are identical, only ``reads_posted`` can differ from a
        one-shot ``drain()``."""
        processed = 0
        self._progress_calls += 1
        while self._queue and (budget is None or processed < budget):
            if isinstance(self._queue[0], CompleteTxn):
                self._do_complete(self._queue.popleft())  # type: ignore[arg-type]
                processed += 1
                continue
            window: list[ReadTxn] = []
            room = None if budget is None else budget - processed
            while self._queue and isinstance(self._queue[0], ReadTxn) and (
                    room is None or len(window) < room):
                window.append(self._queue.popleft())  # type: ignore[arg-type]
            if self.mode == "tensor_centric":
                self._post_reads(window)
            else:
                self._message_rounds(window)
            processed += len(window)
        return processed

    def tick(self, budget: int | None = None) -> int:
        """Event-loop progress hook: advance up to ``budget`` transactions
        (defaulting to the engine's configured ``tick_budget``) and return
        how many were processed.  This is the hook a serving loop calls
        once per tick so transfer work is metered against admission and
        decode work instead of monopolizing the tick."""
        if not self._queue:
            return 0
        return self.progress(self.tick_budget if budget is None else budget)

    def pulled_bytes(self, request_id: str, *, pop: bool = False) -> int:
        """Bytes landed for ``request_id`` so far (executed reads only;
        retries accumulate).  ``pop=True`` retires the entry — callers
        finishing a request should pop so a long-lived engine doesn't
        grow one counter per request ever served."""
        if pop:
            return self._pulled_bytes.pop(request_id, 0)
        return self._pulled_bytes.get(request_id, 0)

    def note_reused(self, request_id: str, nbytes: int) -> None:
        """Record ``nbytes`` a delta transfer plan for ``request_id``
        skipped on the wire (resident prefix graft / content-hash dedup).
        Accumulates across retries, mirroring ``_pulled_bytes`` — a torn
        suffix that re-admits re-grafts and re-notes, just as its re-pull
        re-counts."""
        if nbytes <= 0:
            return
        self._reused_bytes[request_id] += nbytes
        if self.metrics is not None:
            self.metrics.inc("engine.bytes_reused", nbytes)
        if self.tracer.enabled:
            self.tracer.instant("transfer.reuse", track=("request", request_id),
                                bytes=nbytes)

    def reused_bytes(self, request_id: str, *, pop: bool = False) -> int:
        """Bytes skipped for ``request_id`` by delta plans so far (retries
        accumulate); ``pop=True`` retires the entry at request completion,
        like ``pulled_bytes``."""
        if pop:
            return self._reused_bytes.pop(request_id, 0)
        return self._reused_bytes.get(request_id, 0)

    # ------------------------------------------------------------- drain
    def drain(self) -> TransferStats:
        """Process the whole queue (progress-until-empty).  Returns
        cumulative stats — the legacy blocking API."""
        while self._queue:
            self.progress()
        return self.stats

    def _filter_torn(self, window: Sequence[ReadTxn]) -> tuple[list[ReadTxn], ConnectionTornError | None]:
        """Split out reads whose MR is gone (stale submission after a
        teardown): fail their futures NOW and keep the healthy remainder,
        so one torn request cannot poison requests sharing its window.
        Returns (healthy reads, first torn error or None)."""
        if not self.execute_copies:
            return list(window), None  # timed-only engines never touch MRs
        healthy: list[ReadTxn] = []
        first: ConnectionTornError | None = None
        for t in window:
            missing = next((w for w in (t.src_worker, t.dst_worker)
                            if w not in self._regions), None)
            if missing is None:
                healthy.append(t)
            else:
                err = self._torn(missing, t)
                first = first or err
        return healthy, first

    # --------------------------------------------------- tensor-centric
    def _post_reads(self, window: Sequence[ReadTxn]) -> None:
        healthy, torn_err = self._filter_torn(window)
        for t in healthy:
            self._pulled_bytes[t.request_id] += t.nbytes
        self._trace_executed(healthy)
        merged = coalesce(healthy, strategy=self.coalescing)
        self._land(merged)
        for op in merged:
            self.stats.reads_posted += 1
            quantized = self.codec != "none" or op.qscale is not None
            wire = op.nbytes // 2 + 4 if quantized else op.nbytes
            self.stats.bytes_moved += wire
            self.stats.modeled_time_s += self.link.read_time(wire)
        if self.metrics is not None and merged:
            self.metrics.inc("engine.reads_posted", len(merged))
            self.metrics.inc("engine.bytes_moved",
                             sum(op.nbytes for op in merged))
        if self.metrics is not None and healthy:
            self.metrics.inc("engine.bytes_pulled",
                             sum(t.nbytes for t in healthy))
        # torn reads are accounted too — consumed (future already failed),
        # not executed — so a queued COMPLETE for them stays inert instead
        # of raising "reads still queued"
        self._account_executed(window)
        if torn_err is not None:
            raise torn_err

    # ---------------------------------------------------- message mode
    def _message_rounds(self, window: Sequence[ReadTxn]) -> None:
        """Fig. 7a: bounded staging buffer, per-round RPC + gather + send +
        scatter + notify, with REAL double copies under memcpy."""
        healthy, torn_err = self._filter_torn(window)
        for t in healthy:
            self._pulled_bytes[t.request_id] += t.nbytes
        self._trace_executed(healthy)
        round_txns: list[ReadTxn] = []
        round_bytes = 0
        for t in list(healthy) + [None]:  # type: ignore[list-item]
            flush = t is None or (round_bytes + t.nbytes > self.staging_bytes and round_txns)
            if flush and round_txns:
                staging = (torch.empty(round_bytes, dtype=torch.uint8,
                                           device=self._src_view(round_txns[0]).device)
                               if self.execute_copies else None)
                off = 0
                for rt in round_txns:  # gather (copy #1)
                    if staging is not None:
                        staging[off : off + rt.nbytes] = self._src_view(rt)
                    off += rt.nbytes
                off = 0
                for rt in round_txns:  # scatter (copy #2)
                    if staging is not None:
                        self._dst_view(rt).copy_(staging[off : off + rt.nbytes])
                    off += rt.nbytes
                self.stats.rounds += 1
                self.stats.reads_posted += 1
                self.stats.bytes_moved += round_bytes
                self.stats.modeled_time_s += self.link.message_stream_time(
                    round_bytes, len(round_txns))
                if self.metrics is not None:
                    self.metrics.inc("engine.reads_posted")
                    self.metrics.inc("engine.bytes_moved", round_bytes)
                round_txns, round_bytes = [], 0
            if t is not None:
                round_txns.append(t)
                round_bytes += t.nbytes
        self._account_executed(window)
        if torn_err is not None:
            raise torn_err

    # ------------------------------------------------------------ common
    def _trace_executed(self, txns: Sequence[Txn]) -> None:
        """Count executed transactions on their requests' traced pulls:
        read transactions, and the ``progress`` calls that ran any."""
        if not self._pulls:
            return
        for t in txns:
            pull = self._pulls.get(t.request_id)
            if pull is None:
                continue
            if isinstance(t, ReadTxn):
                pull.txns += 1
            if pull.last_call != self._progress_calls:
                pull.last_call = self._progress_calls
                pull.pumps += 1

    def _account_executed(self, window: Sequence[ReadTxn]) -> None:
        """Post-execution bookkeeping: outstanding-read counters and
        per-layer completion marks on the requests' futures."""
        for t in window:
            self._outstanding_reads[t.request_id] -= 1
            if t.layer is None:
                continue
            key = (t.request_id, t.layer)
            self._outstanding_layer[key] -= 1
            if self._outstanding_layer[key] <= 0:
                del self._outstanding_layer[key]
                pull = self._pulls.get(t.request_id)
                if pull is not None:
                    # one span per landed layer: previous layer's end (or
                    # the submit) -> now, on the request's track
                    now = self.tracer.now()
                    self.tracer.complete(
                        f"transfer.layer{t.layer}", ("request", t.request_id),
                        pull.mark, now, layer=t.layer)
                    pull.mark = now
                fut = self._futures.get(t.request_id)
                if fut is not None:
                    fut._layers_done.append(t.layer)
                    # layer callbacks may tear down workers (failover
                    # fires from them in tests): snapshot the list
                    for cb in list(fut._layer_cbs):
                        cb(fut, t.layer)

    @staticmethod
    def _op_request_ids(op: ReadTxn | CoalescedRead) -> tuple[str, ...]:
        if isinstance(op, ReadTxn):
            return (op.request_id,)
        return tuple(dict.fromkeys(op.request_ids))

    def _torn(self, worker_id: str, op: ReadTxn | CoalescedRead) -> ConnectionTornError:
        """Fail the affected futures and build the typed error.  The
        requests' queued COMPLETEs are marked for swallowing: their bytes
        never fully landed, so completion callbacks must not fire."""
        rids = self._op_request_ids(op)
        err = ConnectionTornError(worker_id, rids)
        for rid in rids:
            self._torn_completes.add(rid)
            fut = self._futures.get(rid)
            if fut is not None:
                self._resolve(fut, err)
        return err

    def _src_view(self, op: ReadTxn | CoalescedRead) -> torch.Tensor:
        region = self._regions.get(op.src_worker)
        if region is None:
            raise self._torn(op.src_worker, op)
        return region.view(op.remote)

    def _dst_view(self, op: ReadTxn | CoalescedRead) -> torch.Tensor:
        region = self._regions.get(op.dst_worker)
        if region is None:
            raise self._torn(op.dst_worker, op)
        return region.view(op.local)

    def _land(self, merged: Sequence[CoalescedRead]) -> None:
        """Execute one tick's coalesced reads: per (src, dst) region pair,
        every plain read on pages becomes page-id pairs for ONE ``kv_pull``
        launch, and every quantized read on pages (carried ``qscale``, or
        the engine-wide int8 codec) is quantized on the device and lands
        through ONE ``kv_pull_dequant`` launch.  A read off the pages lands
        alone, as one page of its own length (``_pull_span``)."""
        if not self.execute_copies:
            return
        groups: dict[tuple[str, str], tuple[list, list]] = {}
        for op in merged:
            src = self._regions.get(op.src_worker)
            dst = self._regions.get(op.dst_worker)
            if src is None or dst is None:
                raise self._torn(op.src_worker if src is None else op.dst_worker, op)
            quantized = self.codec != "none" or op.qscale is not None
            if src.page_nbytes != dst.page_nbytes or src.pages(op.remote) is None \
                    or dst.pages(op.local) is None:
                self._pull_span(src, dst, op, quantized)
                continue
            plain, quant = groups.setdefault((op.src_worker, op.dst_worker), ([], []))
            (quant if quantized else plain).append(op)
        for (sw, dw), (plain, quant) in groups.items():
            src, dst = self._regions[sw], self._regions[dw]
            if plain:
                self._pull_pages(src, dst, plain)
            if quant:
                self._pull_quantized(src, dst, quant)

    @staticmethod
    def _page_ids(src: MemoryRegion, dst: MemoryRegion,
                  ops: Sequence[CoalescedRead]) -> tuple[list[int], list[int], list[int]]:
        """(src page ids, dst page ids, index of the op each page came from)."""
        sids: list[int] = []
        dids: list[int] = []
        owner: list[int] = []
        for i, op in enumerate(ops):
            sp, dp = src.pages(op.remote), dst.pages(op.local)
            sids.extend(sp)
            dids.extend(dp)
            owner.extend([i] * len(sp))
        return sids, dids, owner

    def _pull_pages(self, src: MemoryRegion, dst: MemoryRegion,
                    ops: Sequence[CoalescedRead]) -> None:
        sids, dids, _ = self._page_ids(src, dst, ops)
        dev = dst.buffer.device
        kv_pull(src.page_array(), dst.page_array(),
                torch.tensor(sids, dtype=torch.int32, device=dev),
                torch.tensor(dids, dtype=torch.int32, device=dev))

    @staticmethod
    def _scale(span: torch.Tensor, qscale: float | None) -> float:
        """A read's int8 scale: the carried one, else the span's max / 127
        (1.0 for an all-zero span), as the reference computes it."""
        return qscale if qscale is not None else float(span.abs().max()) / 127.0 or 1.0

    def _pull_span(self, src: MemoryRegion, dst: MemoryRegion, op: CoalescedRead,
                   quantized: bool) -> None:
        """One read off the pages: both spans viewed as a ``[1, nbytes]``
        page array, one launch with ids [0] -> [0]."""
        s, d = src.view(op.remote).view(1, -1), dst.view(op.local).view(1, -1)
        ids = torch.zeros(1, dtype=torch.int32, device=d.device)
        if not quantized:
            kv_pull(s, d, ids, ids)
            return
        x = s.view(torch.bfloat16).float()
        sc = torch.tensor([self._scale(x, op.qscale)], dtype=torch.float32, device=d.device)
        q = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
        kv_pull_dequant(q, d.view(torch.bfloat16), ids, ids, sc)

    def _pull_quantized(self, src: MemoryRegion, dst: MemoryRegion,
                        ops: Sequence[CoalescedRead]) -> None:
        """int8 transport: quantize the bf16 spans with their scales, move
        int8, dequantize into the destination.  A carried ``op.qscale``
        (delta-plan quantized pull) is used as-is; otherwise (engine-wide
        ``codec="int8_transport"``) the scale is computed per coalesced
        read from the span's max, as the reference does."""
        sids, dids, owner = self._page_ids(src, dst, ops)
        dev = dst.buffer.device
        s = src.page_array(torch.bfloat16)[
            torch.tensor(sids, dtype=torch.long, device=dev)].float()
        scales = []
        for i, op in enumerate(ops):
            if op.qscale is not None:
                scales.append(op.qscale)
            else:
                scales.append(self._scale(s[[j for j, o in enumerate(owner) if o == i]], None))
        sc = torch.tensor([scales[o] for o in owner], dtype=torch.float32, device=dev)
        q = torch.clamp(torch.round(s / sc[:, None]), -127, 127).to(torch.int8)
        kv_pull_dequant(q, dst.page_array(torch.bfloat16),
                        torch.arange(len(sids), dtype=torch.int32, device=dev),
                        torch.tensor(dids, dtype=torch.int32, device=dev), sc)

    def _do_complete(self, txn: CompleteTxn) -> None:
        if txn.request_id in self._torn_completes:
            # the transfer failed mid-flight (future already failed):
            # swallow its COMPLETE so the prefill side keeps the only
            # surviving KV copy for the re-route
            self._torn_completes.discard(txn.request_id)
            return
        if self._outstanding_reads[txn.request_id] > 0:
            raise RuntimeError(
                f"COMPLETE for {txn.request_id!r} with "
                f"{self._outstanding_reads[txn.request_id]} reads still queued — "
                "the decode worker must enqueue COMPLETE after all TRANSFERs"
            )
        # Serialized by ACK: one mailbox slot per connection, strictly FIFO
        # (we drain in order, so FIFO holds; the cost of the ACK is modeled).
        self.stats.completes += 1
        self.stats.modeled_time_s += self.link.ack_rtt_s
        if self.metrics is not None:
            self.metrics.inc("engine.completes")
        self._trace_executed((txn,))
        for cb in self._complete_cbs:
            cb(txn)
        fut = self._futures.get(txn.request_id)
        if fut is not None:
            self._resolve(fut)
