"""Serving workers: real model compute + real KV bytes through KVDirect —
the port of ``src/repro/serving/engine.py``.

``PrefillWorker`` runs the model's prefill, lands the produced KV pages
in its PagedKVCache slab on its device (the registered MR the transfer
engine reads from), and registers descriptors.  ``DecodeWorker`` pulls
KV through the transfer engine (pull_kv → one-sided reads + COMPLETE,
landed by the kv_pull kernel), builds a DecodeState from its own slab,
and decodes with continuous batching.

What differs from the reference: the host float32 page caches and the
bf16 <-> f32 rebuilds become device tensor ops in bf16 (the resident
page cache, the batch state and the layerwise fetch are gathered straight
from the slab in its own dtype); block digests copy each parked block's
bytes to the host once; the int8 scales come from one device reduction.
Swapped-out KV (``SwappedKV``) is parked in host memory in bf16.

Tracing (with an enabled tracer; the disabled one costs an attribute
check a site): a prefill records ``prefill.forward`` (the model and the
first token's argmax), ``prefill.park``, ``prefill.digest`` and, with
``quantize_transfer``, ``prefill.quant`` on the prefill worker's track;
a decode step records ``step.pump``, ``step.rebuild``, ``step.launch``
(the host issuing the forward and the argmax) and ``step.sync`` (the
host waiting for the step's tokens) on the decode worker's track, inside
the serving loop's ``tick.step``.  The parts of a step do not overlap.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.connection import Connection, DescriptorRegistry, WorkerInfo
from repro_torch.core.pull_push import pull_kv_async
from repro_torch.core.transfer_engine import ConnectionTornError, TransferEngine, TransferFuture
from repro_torch.models.transformer import DecodeState
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.blocks import BlockPool, OutOfBlocks
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.request import Request, RequestState

__all__ = ["PrefillWorker", "DecodeWorker", "SwappedKV"]


class PrefillWorker:
    def __init__(self, info: WorkerInfo, model, params, *, num_blocks: int = 256,
                 base_address: int = 0x7F06F40000,
                 quantize_transfer: bool = False,
                 tracer=None):
        """``quantize_transfer``: compute per-(layer, block, plane) int8
        scales at park time so decode-side pulls move quantized wire
        bytes with the scale carried in each ``ReadTxn`` descriptor
        (docs/transfer.md § quantized transfer)."""
        self.tracer = tracer if tracer is not None else NULL_TRACER
        cfg = model.cfg
        if not cfg.has_attention or cfg.sliding_window:
            raise NotImplementedError(
                "CPU serving path covers paged-KV archs; SSM/SWA archs use "
                "SlotCache transfer (see tests/test_pull_push.py)")
        self.info = info
        self.model = model
        self.params = params
        self.device = model.device  # compute and KV slab live with the weights
        self.block_size = model.BLOCK_SIZE
        self.cache = PagedKVCache(
            info.worker_id,
            num_layers=cfg.num_layers,
            num_blocks=num_blocks,
            block_size=self.block_size,
            kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            base_address=base_address,
            device=self.device,
        )
        self.pool = BlockPool(num_blocks, block_size=self.block_size)
        self.quantize_transfer = quantize_transfer
        self.registry = DescriptorRegistry(info.worker_id)
        for d in self.cache.descriptors():
            self.registry.register(d)

    def _digest_blocks(self, blocks: list[int]) -> list[str]:
        """Content hash per parked block: blake2b over the block's K and V
        slab bytes across ALL layers.  A block's KV encodes its full
        prefix context (causal attention), so byte equality between two
        parked blocks at the same position means the prompts agree up
        through that block — a hash hit is safe to dedup on the wire."""
        hashers = [hashlib.blake2b(digest_size=16) for _ in blocks]
        # one device -> host copy of every parked block: [L, 2, n, bs, g, hd]
        host = self.cache.gather_blocks(blocks).cpu().view(torch.uint8).numpy()
        for layer in range(self.cache.num_layers):
            for j, h in enumerate(hashers):
                h.update(host[layer, 0, j].tobytes())
                h.update(host[layer, 1, j].tobytes())
        return [h.hexdigest() for h in hashers]

    def _quant_scales(self, blocks: list[int]) -> list[list[tuple[float, float]]]:
        """Per-(layer, block position, plane) symmetric-int8 scales:
        ``scales[layer][pos] = (k_scale, v_scale)``, plane order matching
        ``TensorDesc.block_ranges`` (ascending offset = K then V)."""
        # one device reduction: max |x| per (layer, plane, block)
        amax = self.cache.gather_blocks(blocks).float().abs().amax(dim=(3, 4, 5))
        amax = amax.cpu().tolist()  # [L][2][n]
        return [[tuple(amax[layer][plane][j] / 127.0 or 1.0 for plane in (0, 1))
                 for j in range(len(blocks))]
                for layer in range(self.cache.num_layers)]

    def _compute_and_park(
        self, tokens: np.ndarray, rid: str | None = None
    ) -> tuple[int, list[int], list[str], list | None]:
        """Run the model prefill and land the KV pages in the slab.
        Returns (first token, allocated blocks, per-block content hashes,
        quant scales or None).  Capacity is checked UP FRONT: a full pool
        must raise before any state transition or model compute — a
        queued dispatch retries from QUEUED_PREFILL, which an
        after-the-fact OutOfBlocks would strand in PREFILLING.  ``rid``
        tags the spans (None for a hedge twin's shadow prefill)."""
        need = BlockPool.blocks_for_tokens(len(tokens), self.block_size)
        if not self.pool.can_allocate(need):
            raise OutOfBlocks(f"need {need} blocks: pool {self.pool.describe()}")
        tr, track, n = self.tracer, ("worker", self.info.worker_id), len(tokens)
        with tr.span("prefill.forward", track=track, rid=rid, tokens=n):
            logits, state = self.model.prefill(
                self.params,
                {"tokens": torch.as_tensor(np.asarray(tokens)[None], device=self.device)},
                max_blocks_margin=0, remat=False,
            )
            first = int(torch.argmax(logits[0, : self.model.cfg.vocab_size].float()))
        with tr.span("prefill.park", track=track, rid=rid, tokens=n):
            k_pages = state.k_pages[:, 0]  # [L, spb, bs, g, hd]
            v_pages = state.v_pages[:, 0]
            blocks = self.pool.allocate(k_pages.shape[1])
            self.cache.write_blocks(blocks, k_pages, v_pages)
        with tr.span("prefill.digest", track=track, rid=rid, tokens=n,
                     bytes=len(blocks) * self.cache.block_total_nbytes):
            hashes = self._digest_blocks(blocks)
        scales = None
        if self.quantize_transfer:
            with tr.span("prefill.quant", track=track, rid=rid, tokens=n):
                scales = self._quant_scales(blocks)
        return first, blocks, hashes, scales

    def prefill(self, req: Request, tokens: np.ndarray) -> int:
        """Run prefill, park KV blocks in the slab, return the first
        token.  Raises OutOfBlocks BEFORE the PREFILLING transition when
        the pool cannot hold the prompt, so the request stays re-
        dispatchable (QUEUED_PREFILL) for the serving loop's next tick."""
        need = BlockPool.blocks_for_tokens(len(tokens), self.block_size)
        if not self.pool.can_allocate(need):
            raise OutOfBlocks(f"need {need} blocks: pool {self.pool.describe()}")
        req.to(RequestState.PREFILLING)
        first, req.prefill_blocks, req.block_hashes, req.kv_scales = \
            self._compute_and_park(tokens, req.request_id)
        return first

    def prefill_shadow(
        self, tokens: np.ndarray
    ) -> tuple[int, list[int], list[str], list | None]:
        """Hedge-twin prefill: same compute and slab landing as
        ``prefill`` but WITHOUT touching any request state — the serving
        layer tracks the twin copy and frees it when the primary's
        transfer COMPLETEs (loser aborted) or adopts it on failover."""
        return self._compute_and_park(tokens)

    def release(self, req: Request) -> None:
        """COMPLETE() arrived: free the request's prefill-side blocks."""
        if req.prefill_blocks:
            self.pool.free(req.prefill_blocks)
            req.prefill_blocks = []


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class _Resident:
    req: Request
    blocks: list[int]
    context_len: int
    last_token: int
    # device page cache (slab dtype) built lazily from the slab:
    # [L, n, bs, heads, hd].  Extended only when blocks are appended.
    k_cached: torch.Tensor | None = None
    v_cached: torch.Tensor | None = None
    # The block ids the cache columns were gathered from.  The cache is
    # valid only while ``blocks`` still starts with exactly these ids —
    # a mutated block list (delta-grafted prefix swapped, failover
    # reassignment) must invalidate, not serve stale pages.
    cached_from: tuple[int, ...] = ()


@dataclasses.dataclass
class _InFlight:
    """An admission whose KV pull is still in the air."""

    req: Request
    first_token: int
    future: TransferFuture


@dataclasses.dataclass
class SwappedKV:
    """A preempted resident's full KV, parked in host memory.

    ``k_pages``/``v_pages`` are the bf16 pages the resident's compute
    path was using ([L, pages, bs, heads, hd]), on the host — pulled AND
    decode-appended pages, flushed through ``_invalidate_step`` first, so
    a resume continues from byte-identical state.  The entry is worker-
    agnostic: any decode worker can ``swap_in`` it (the pages carry no
    worker-local identity), which is what lets a drain migrate swapped
    victims off a retiring worker.

    ``nbytes`` counts 4 bytes an element, as the reference's float32 host
    pages take, so a ``HostSwapPool`` byte budget admits the same swaps
    (and forces the same sacrifices) as the reference service does."""

    req: Request
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    context_len: int
    last_token: int

    REF_ELEMENT_BYTES = 4  # float32, src/repro/serving/engine.py SwappedKV

    @property
    def nbytes(self) -> int:
        return int((self.k_pages.numel() + self.v_pages.numel()) * self.REF_ELEMENT_BYTES)


class DecodeWorker:
    """Continuous-batching decode over KV pulled through the engine.

    ``consume`` picks the synchronization contract between a request's KV
    pull and its first decode step:

    * ``"full"`` (default) — a request joins decode only after its whole
      pull resolved (COMPLETE executed).  Transfer still overlaps OTHER
      requests' decode compute via ``pump``.
    * ``"layerwise"`` — the pipelined consumer: an in-flight admission
      joins the next ``decode_round`` as soon as its KV starts landing;
      the round's FIRST step fetches layer *l*'s pages via
      ``TransferFuture.wait_layer(l)`` right before layer *l*'s attention
      runs, so early layers compute while late layers are still on the
      wire.  A teardown BETWEEN layers fails the torn request's future
      (``ConnectionTornError``); the step is re-run without it, so
      survivors' tokens are unchanged (see docs/transfer.md).
    """

    def __init__(self, info: WorkerInfo, model, params, *, num_blocks: int = 256,
                 engine: TransferEngine | None = None,
                 base_address: int = 0x7F80000000,
                 consume: str = "full",
                 step_margin_blocks: int = 2,
                 prefix_cache_cap: int = 4,
                 delta_transfer: bool = True,
                 tracer=None,
                 metrics=None):
        if consume not in ("full", "layerwise"):
            raise ValueError(f"consume must be 'full' or 'layerwise', got {consume!r}")
        self.consume = consume
        self.delta_transfer = delta_transfer
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        cfg = model.cfg
        self.info = info
        self.model = model
        self.params = params
        self.device = model.device  # compute and KV slab live with the weights
        self.block_size = model.BLOCK_SIZE
        self.cache = PagedKVCache(
            info.worker_id,
            num_layers=cfg.num_layers,
            num_blocks=num_blocks,
            block_size=self.block_size,
            kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            base_address=base_address,
            device=self.device,
        )
        self.pool = BlockPool(num_blocks, block_size=self.block_size)
        self.engine = engine or TransferEngine()
        self.engine.register_memory(self.cache.memory_region())
        self.resident: dict[str, _Resident] = {}
        self.inflight: dict[str, _InFlight] = {}
        # Continuous-batching step state (see step()): the device
        # DecodeState persists ACROSS steps and is rebuilt — losslessly —
        # only when batch membership changes or the page margin runs out.
        self.step_margin_blocks = max(1, step_margin_blocks)
        self._step_ids: list[str] = []
        self._step_state: DecodeState | None = None
        self._step_tokens: torch.Tensor | None = None
        self._step_per_seq = 0
        # Prefix retention: finished requests' shared-prefix blocks stay
        # refcounted in the pool (LRU, bounded) so prefix-affinity
        # routing has something real to aim at; evicted under pressure.
        self.prefix_cache: collections.OrderedDict[str, list[int]] = \
            collections.OrderedDict()
        self.prefix_cache_cap = prefix_cache_cap
        # Content-hash dedup index: prefill-computed block hash -> a slab
        # block currently holding that content.  Exact inverses — only the
        # indexed block is recorded in _block_hash.  Entries register at
        # promotion (never for in-flight pulls: their bytes haven't
        # landed) and purge when the pool actually releases the block.
        self._hash_index: dict[str, int] = {}
        self._block_hash: dict[int, str] = {}
        self._track = ("worker", info.worker_id)  # the step spans' track
        self.pumped = 0  # transactions the last ``pump`` executed

    # ------------------------------------------------------------ admit
    def _plan_reuse(self, req: Request) -> dict[int, int]:
        """Delta transfer plan: block POSITION -> resident slab block
        already holding that position's KV bytes.  Two sources, prefix
        graft first (it needs no hashes and so covers pre-hash senders):

        * prefix graft — the request's ``prefix_id`` is retained here;
          its whole-block prefix run maps positionally onto the cached
          blocks (PR 5's retention contract: same prefix_id ⇒ identical
          first prefix_len tokens);
        * content-hash dedup — any remaining position whose prefill
          block hash matches a landed resident block, across requests
          with no shared prefix_id at all.
        """
        n = len(req.prefill_blocks)
        reuse: dict[int, int] = {}
        pid = req.prefix_id
        if pid and pid in self.prefix_cache:
            pblocks = self.prefix_cache[pid]
            limit = min(len(pblocks), n,
                        (req.prefix_len or req.prompt_len) // self.block_size)
            for pos in range(limit):
                reuse[pos] = pblocks[pos]
            self.prefix_cache.move_to_end(pid)
        for pos in range(min(n, len(req.block_hashes))):
            if pos in reuse:
                continue
            blk = self._hash_index.get(req.block_hashes[pos])
            if blk is not None:
                reuse[pos] = blk
        return reuse

    def admit_async(self, req: Request, conn: Connection, first_token: int) -> TransferFuture:
        """Event-driven pull-mode admission: allocate, submit the layer-
        streamed pull, return immediately.  The transfer advances when the
        worker calls ``pump()`` (typically interleaved with decode steps),
        and the request is promoted to DECODING the moment its future
        resolves.

        Delta transfer: positions already resident (retained prefix /
        hash dedup) are GRAFTED — ``pool.share``d into the request's
        block list — and skipped on the wire; only the suffix is pulled.
        The share happens BEFORE the suffix allocation so the eviction
        fallback below can only decrement the grafted blocks' refcounts,
        never corrupt them; a torn suffix therefore aborts cleanly (the
        grafted prefix just un-shares) and a re-admission re-grafts and
        re-notes reused bytes, mirroring pulled-bytes retry accounting.

        Allocation happens BEFORE any state transition so an OutOfBlocks
        failure leaves the request exactly as it was (KV_QUEUED, prefill
        KV alive) — the caller's retry contract depends on it.  Retained
        prefix blocks are evicted (LRU) before giving up: the retention
        cache is opportunistic and must never starve live admissions."""
        req = getattr(req, "request", req)  # a RequestHandle delegates
        # reads but not WRITES (pull_kv_async assigns decode_blocks), so
        # admission must operate on the underlying Request
        n = len(req.prefill_blocks)
        reuse = self._plan_reuse(req) if self.delta_transfer else {}
        grafted = [reuse[p] for p in sorted(reuse)]
        if grafted:
            self.pool.share(grafted)
        need = n - len(grafted)
        try:
            try:
                fresh = self.pool.allocate(need) if need else []
            except OutOfBlocks:
                if not self._evict_prefixes(need):
                    raise
                fresh = self.pool.allocate(need)
        except OutOfBlocks:
            if grafted:
                self._free_blocks(grafted)  # un-share; request unchanged
            raise
        it = iter(fresh)
        blocks = [reuse[p] if p in reuse else next(it) for p in range(n)]
        req.to(RequestState.KV_TRANSFER)
        # the lifecycle track's "transfer" phase: queue.kv ends the moment
        # the pull is SUBMITTED (bytes may start moving this tick), so the
        # engine's ``pull`` span lies inside the phase
        self.tracer.phase(("request", req.request_id), "transfer",
                          worker=self.info.worker_id, blocks=len(blocks),
                          reused_blocks=len(grafted))
        fut = pull_kv_async(req, conn=conn, engine=self.engine,
                            decode_pool=self.pool, decode_cache=self.cache,
                            preallocated=blocks, skip=frozenset(reuse))
        if grafted:
            self.engine.note_reused(req.request_id,
                                    len(grafted) * self.cache.block_total_nbytes)
        self.inflight[req.request_id] = _InFlight(req, first_token, fut)
        if self.metrics is not None:
            self.metrics.inc("decode.admitted")
            if grafted:
                self.metrics.inc("decode.blocks_grafted", len(grafted))
        return fut

    def admit_batch(
        self, admissions: Sequence[tuple[Request, Connection, int]]
    ) -> list[TransferFuture]:
        """Admit a batch of KV_QUEUED requests in one go: every pull is
        submitted before any byte moves, so the whole batch pipelines
        behind decode compute instead of serializing admission-by-
        admission (coalescing itself stays per-request — each COMPLETE
        ends a window).  Admits in order, stopping at the first request
        that doesn't fit (FIFO fairness — later arrivals must not starve
        it); returns the futures of the admitted prefix."""
        futures: list[TransferFuture] = []
        for req, conn, first_token in admissions:
            try:
                futures.append(self.admit_async(req, conn, first_token))
            except OutOfBlocks:
                break
        return futures

    def admit(self, req: Request, conn: Connection, first_token: int) -> None:
        """Blocking admission (legacy): submit the pull and drain it to
        completion before returning.  Byte-identical to the async path —
        it IS the async path, progressed until resolved."""
        fut = self.admit_async(req, conn, first_token)
        try:
            self.engine.drain()
        except Exception:
            # drain may raise ANOTHER request's torn error; only clean up
            # our admission if OUR pull actually died (abort requires a
            # resolved future — queued reads must not write freed blocks)
            if fut.failed:
                self.abort(req.request_id)
            raise
        if fut.failed:
            self.abort(req.request_id)
            raise fut.exception()
        self.pump(0)  # promote (no more transfer work to do)
        assert req.request_id in self.resident

    def abort(self, request_id: str) -> bool:
        """Drop an in-flight admission whose pull died (connection torn /
        failover): free the decode-side blocks and forget the entry.  The
        caller must only abort once the future is resolved — queued reads
        into the freed blocks would otherwise still execute."""
        fl = self.inflight.pop(request_id, None)
        if fl is None:
            return False
        if fl.req.decode_blocks:
            # grafted (shared) blocks merely decrement — the retained
            # prefix / dedup source they came from stays intact, so a
            # torn suffix never corrupts resident state
            self._free_blocks(fl.req.decode_blocks)
            fl.req.decode_blocks = []
        return True

    # -------------------------------------------------------------- pump
    def pump(self, budget: int | None = None) -> list[str]:
        """Advance in-flight pulls by up to ``budget`` transactions and
        promote every request whose future resolved to DECODING.  Returns
        the promoted request ids.  Failed futures (torn connections) are
        aborted here — their requests stay in KV_TRANSFER for the serving
        layer's failover to re-route.  ``pumped`` holds the transactions
        the engine executed."""
        self.pumped = 0
        if self.inflight and self.engine.pending:
            self.pumped = self.engine.progress(budget)
        self.engine.poll()  # keep the shared completion queue drained
        promoted: list[str] = []
        for rid, fl in list(self.inflight.items()):
            if not fl.future.done():
                continue
            if fl.future.failed:
                self.abort(rid)  # one owner for the torn-pull cleanup
                continue
            del self.inflight[rid]
            req = fl.req
            req.to(RequestState.QUEUED_DECODE)
            self.resident[rid] = _Resident(
                req, req.decode_blocks, req.prompt_len, fl.first_token)
            req.to(RequestState.DECODING)
            self._register_hashes(req)  # bytes landed: dedupable now
            # transfer ends when the request JOINS decode (promotion), so
            # resolve→promote latency is charged to transfer, not decode
            self.tracer.phase(("request", rid), "decode",
                              worker=self.info.worker_id)
            if self.metrics is not None:
                self.metrics.inc("decode.promoted")
            promoted.append(rid)
        return promoted

    # ------------------------------------------------------------ decode
    def _gather_pages(self, blocks: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """Slab → pages for ``blocks``: [L, n, bs, heads, hd], one gather."""
        kv = self.cache.gather_blocks(blocks)
        return kv[:, 0], kv[:, 1]

    def _resident_pages(self, r: _Resident) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-request page cache: gather/cast from the slab only for
        blocks not seen before, reuse the rest.  The cache is keyed on
        WHICH blocks its columns came from (``cached_from``), not just
        how many: if the resident's block list no longer starts with the
        blocks the cache was gathered from (delta graft swapped the
        prefix, failover reassigned blocks), the whole cache is rebuilt —
        a count-only check would silently serve the old blocks' pages."""
        if r.k_cached is not None and \
                list(r.cached_from) != r.blocks[: len(r.cached_from)]:
            r.k_cached = r.v_cached = None
            r.cached_from = ()
        cached = 0 if r.k_cached is None else r.k_cached.shape[1]
        if cached < len(r.blocks):
            k_new, v_new = self._gather_pages(r.blocks[cached:])
            r.k_cached = k_new if r.k_cached is None else torch.cat(
                [r.k_cached, k_new], dim=1)
            r.v_cached = v_new if r.v_cached is None else torch.cat(
                [r.v_cached, v_new], dim=1)
            r.cached_from = tuple(r.blocks)
        return r.k_cached, r.v_cached

    def _round_margin(self, max_new: int) -> int:
        """Page-margin for one decode round: room for max_new appends."""
        return -(-max_new // self.block_size)

    def _pages_of(self, r: _Resident) -> int:
        """Valid KV pages of a resident: its pulled slab blocks, plus any
        pages grown past them by decode-appended tokens (those live only
        in the page cache after a state writeback)."""
        return max(len(r.blocks), -(-r.context_len // self.block_size))

    def _batch_tables(self, batch: list[_Resident], margin_blocks: int):
        """Shared batch layout (per_seq width + identity block tables) —
        ONE definition so the full and layerwise paths cannot diverge."""
        per_seq = max(self._pages_of(r) for r in batch) + margin_blocks
        tables = torch.arange(per_seq, dtype=torch.int32, device=self.device)
        return per_seq, tables[None].repeat(len(batch), 1)

    def _context_lens(self, batch: list[_Resident]) -> torch.Tensor:
        return torch.tensor([r.context_len for r in batch], dtype=torch.int32,
                            device=self.device)

    def _last_tokens(self, batch: list[_Resident]) -> torch.Tensor:
        return torch.tensor([r.last_token for r in batch], dtype=torch.int32,
                            device=self.device)

    def _build_state(self, batch: list[_Resident], margin_blocks: int) -> DecodeState:
        """Assemble a per-seq paged DecodeState from the residents' page
        caches (slab reads only for newly pulled blocks)."""
        cfg = self.model.cfg
        bs = self.block_size
        L = cfg.num_layers
        per_seq, tables = self._batch_tables(batch, margin_blocks)
        b = len(batch)
        k_pages = torch.zeros((L, b, per_seq, bs, cfg.num_kv_heads, cfg.head_dim),
                              dtype=self.cache.dtype, device=self.device)
        v_pages = torch.zeros_like(k_pages)
        for i, r in enumerate(batch):
            k, v = self._resident_pages(r)
            n = k.shape[1]
            k_pages[:, i, :n] = k
            v_pages[:, i, :n] = v
        return DecodeState(
            context_lens=self._context_lens(batch),
            k_pages=k_pages,
            v_pages=v_pages,
            block_tables=tables,
        )

    def _argmax_tokens(self, logits) -> torch.Tensor:
        return torch.argmax(
            logits[:, : self.model.cfg.vocab_size].float(), dim=-1
        ).to(torch.int32)

    # ----------------------------------------- layerwise first step
    def _layerwise_first_step(self, streaming: list[_InFlight],
                              margin_blocks: int, pump_budget: int | None):
        """One decode step where ``streaming`` (in-flight) admissions join
        the resident batch, consuming each layer's KV as its reads land
        (``wait_layer`` pumps the engine between layers).  Returns
        ``(batch, state, tokens, out)`` with the first round token already
        recorded; raises ``ConnectionTornError`` if any streaming pull
        dies mid-step (the caller retries without it)."""
        cfg = self.model.cfg
        bs = self.block_size
        residents = list(self.resident.values())
        batch = residents + [
            _Resident(fl.req, fl.req.decode_blocks, fl.req.prompt_len,
                      fl.first_token)
            for fl in streaming
        ]
        b = len(batch)
        per_seq, tables = self._batch_tables(batch, margin_blocks)

        def fetch(layer: int):
            # the synchronization point of the whole design: block until
            # THIS layer's reads executed, not until the pull resolves
            for fl in streaming:
                fl.future.wait_layer(layer, budget=pump_budget)
            k = torch.zeros((b, per_seq, bs, cfg.num_kv_heads, cfg.head_dim),
                            dtype=self.cache.dtype, device=self.device)
            v = torch.zeros_like(k)
            kplane, vplane = self.cache.kv_planes(layer)
            for i, r in enumerate(batch):
                if i < len(residents):
                    # resident: reuse the page cache (pulled AND decode-
                    # appended pages) instead of re-gathering every round
                    rk, rv = self._resident_pages(r)
                    n = rk.shape[1]
                    k[i, :n], v[i, :n] = rk[layer], rv[layer]
                else:  # streaming: this layer's bytes just landed
                    idx = torch.as_tensor(r.blocks, dtype=torch.long,
                                          device=self.device)
                    n = len(r.blocks)
                    k[i, :n] = kplane[idx]
                    v[i, :n] = vplane[idx]
            return k, v

        tr = self.tracer
        with tr.span("step.launch", track=self._track, batch=b):
            # the layers' fetches pump the engine inside the forward
            state = DecodeState(
                context_lens=self._context_lens(batch),
                block_tables=tables,
            )
            tokens = self._last_tokens(batch)
            logits, state = self.model.decode_step_layerwise(
                self.params, state, tokens, fetch)
            tokens = self._argmax_tokens(logits)
        # All layers landed; the pulls' COMPLETE tails resolve now.  A
        # failure here (torn after the last layer, COMPLETE swallowed)
        # invalidates the admission exactly like a mid-layer tear.
        with tr.span("step.pump", track=self._track) as s:
            txns = 0
            for fl in streaming:
                while not fl.future.done():
                    if not self.engine.pending:
                        raise RuntimeError(
                            f"transfer of {fl.req.request_id!r} has no COMPLETE queued")
                    txns += self.engine.progress(pump_budget)
            for fl in streaming:
                if fl.future.failed:
                    raise fl.future.exception()
            # promote the resolved admissions (no transfer work)
            s.set(txns=txns, promoted=len(self.pump(0)))
        for r in batch[len(residents):]:
            # keep OUR entry: it reflects the step this round already ran
            self.resident[r.req.request_id] = r
        with tr.span("step.sync", track=self._track):
            host = tokens.tolist()
        out: dict[str, list[int]] = {r.req.request_id: [] for r in batch}
        for i, r in enumerate(batch):
            out[r.req.request_id].append(host[i])
            r.req.tokens_generated += 1
        return batch, state, tokens, out

    def _streaming_step(self, margin_blocks: int, pump_budget: int | None):
        """Run the layerwise first step over every in-flight admission,
        dropping (and aborting) admissions whose pull is torn mid-step and
        retrying with the survivors — a teardown BETWEEN layers must not
        change the survivors' tokens, so the step restarts cleanly (no
        tokens or state were committed yet)."""
        while self.inflight:
            streaming = list(self.inflight.values())
            try:
                return self._layerwise_first_step(
                    streaming, margin_blocks, pump_budget)
            except ConnectionTornError:
                # torn futures are resolved; pump aborts their admissions
                # (frees decode blocks) and keeps the healthy ones in
                # flight for the retry
                self.pump(0)
        return None

    # --------------------------------------------- persistent step state
    def _install_step(self, batch: list[_Resident], state: DecodeState,
                      tokens: torch.Tensor) -> None:
        self._step_ids = [r.req.request_id for r in batch]
        self._step_state = state
        self._step_tokens = tokens
        self._step_per_seq = int(state.block_tables.shape[1])

    def _invalidate_step(self) -> None:
        """Flush the persistent step state back into the residents' page
        caches and drop it.  The writeback copies the state's KV — pulled
        AND decode-appended pages — so the batch can be rebuilt around a
        membership change (join / leave / finish) without losing appended
        tokens.  The copy stays in the slab's dtype, so a rebuild never
        perturbs the survivors' subsequent tokens."""
        state = self._step_state
        if state is None:
            return
        ids, self._step_ids = self._step_ids, []
        self._step_state = self._step_tokens = None
        self._step_per_seq = 0
        for i, rid in enumerate(ids):
            r = self.resident.get(rid)
            if r is None:
                continue  # finished / aborted while the state was live
            pages = -(-r.context_len // self.block_size)
            r.k_cached = state.k_pages[:, i, :pages].clone()
            r.v_cached = state.v_pages[:, i, :pages].clone()
            r.cached_from = tuple(r.blocks)  # writeback covers all blocks

    def _commit_step(self, batch: list[_Resident], state: DecodeState,
                     tokens: torch.Tensor) -> dict[str, int]:
        """Record one step's outputs on the residents; returns
        request_id -> token."""
        with self.tracer.span("step.sync", track=self._track):
            ctx = state.context_lens.tolist()
            host = tokens.tolist()
        out: dict[str, int] = {}
        for i, r in enumerate(batch):
            tok = host[i]
            out[r.req.request_id] = tok
            r.req.tokens_generated += 1
            r.context_len = ctx[i]
            r.last_token = tok
        return out

    # ------------------------------------------------- continuous stepping
    def step(self, *, pump_budget: int | None = 32) -> dict[str, int]:
        """ONE continuous-batching decode step: every resident advances by
        one token and the mapping ``{request_id: token}`` is returned.

        This is ``decode_round`` split open for the event-driven serving
        loop: requests JOIN the running batch the moment their pull
        resolves (``consume="full"``) or stream their KV in layer-by-layer
        during this very step (``consume="layerwise"``, preserving the
        PR 3 ``ConnectionTornError`` retry semantics), and LEAVE whenever
        the caller stops stepping them (``finish``) — cohabitants never
        stall on either event.  The device DecodeState persists across
        steps; membership changes or an exhausted page margin trigger a
        lossless rebuild (see ``_invalidate_step``), so a join/leave never
        changes the tokens of requests already in the batch."""
        if self.consume == "layerwise" and self.inflight:
            with self.tracer.span("step.rebuild", track=self._track,
                                  batch=len(self.resident)):
                self._invalidate_step()  # caches must be current to co-batch
            stream = self._streaming_step(self.step_margin_blocks, pump_budget)
            if stream is not None:
                batch, state, tokens, out = stream
                # commit the step's context_len/last_token NOW: a rebuild
                # on the very next step (another join, a leave, margin)
                # writes back and restarts from these fields — stale
                # values would replay the token and drop an appended page
                with self.tracer.span("step.sync", track=self._track):
                    ctx = state.context_lens.tolist()
                    host = tokens.tolist()
                for i, r in enumerate(batch):
                    r.context_len = ctx[i]
                    r.last_token = host[i]
                self._install_step(batch, state, tokens)
                return {rid: toks[0] for rid, toks in out.items()}
        else:
            # promote pulls that resolved since the last step (and nudge
            # the engine while there is in-flight work to hide)
            self._step_pump(pump_budget if self.inflight else 0)
        if not self.resident:
            return {}
        ids = list(self.resident)
        exhausted = self._step_state is not None and any(
            r.context_len >= self._step_per_seq * self.block_size
            for r in self.resident.values())
        if ids != self._step_ids or exhausted:
            with self.tracer.span("step.rebuild", track=self._track) as s:
                self._invalidate_step()
                batch = list(self.resident.values())
                state = self._build_state(batch, margin_blocks=self.step_margin_blocks)
                tokens = self._last_tokens(batch)
                self._install_step(batch, state, tokens)
                if self.tracer.enabled:
                    s.set(batch=len(batch), per_seq=self._step_per_seq,
                          bytes=_nbytes(state.k_pages, state.v_pages)
                          + sum(_nbytes(r.k_cached, r.v_cached) for r in batch))
        batch = [self.resident[rid] for rid in self._step_ids]
        with self.tracer.span("step.launch", track=self._track, batch=len(batch)):
            logits, state = self.model.decode_step(
                self.params, self._step_state, self._step_tokens)
            tokens = self._argmax_tokens(logits)
        if self.inflight:
            self._step_pump(pump_budget)  # transfer hides behind the step
        out = self._commit_step(batch, state, tokens)
        self._step_state, self._step_tokens = state, tokens
        return out

    def _step_pump(self, budget: int) -> None:
        with self.tracer.span("step.pump", track=self._track) as s:
            s.set(promoted=len(self.pump(budget)), txns=self.pumped)

    def decode_round(self, max_new: int = 8, *,
                     pump_budget: int | None = 32) -> dict[str, list[int]]:
        """Round-style decode: the CURRENT residents (plus, for
        ``consume="layerwise"``, in-flight admissions streamed into the
        first step) each produce ``max_new`` tokens.  Returns generated
        ids.  The batch is fixed for the round — pulls resolving mid-round
        are promoted but join at the NEXT round; the event-driven path
        (``step``) is what admits them mid-stream.

        Between decode steps the worker pumps the transfer engine by
        ``pump_budget`` transactions, so in-flight pulls make progress
        behind decode compute."""
        self._invalidate_step()  # interop with step(): flush its state
        stream = None
        if self.consume == "layerwise" and self.inflight and max_new > 0:
            stream = self._streaming_step(self._round_margin(max_new), pump_budget)
        if stream is not None:
            batch, state, tokens, out = stream
            steps_left = max_new - 1
        else:
            if not self.resident:
                self.pump(pump_budget)
                if not self.resident:
                    return {}
            batch = list(self.resident.values())
            state = self._build_state(batch, margin_blocks=self._round_margin(max_new))
            tokens = self._last_tokens(batch)
            out = {r.req.request_id: [] for r in batch}
            steps_left = max_new
        for _ in range(steps_left):
            logits, state = self.model.decode_step(self.params, state, tokens)
            if self.inflight:
                self.pump(pump_budget)  # transfer hides behind the step
            tokens = self._argmax_tokens(logits)
            host = tokens.tolist()
            for i, r in enumerate(batch):
                out[r.req.request_id].append(host[i])
                r.req.tokens_generated += 1
        ctx = state.context_lens.tolist()
        host = tokens.tolist()
        for i, r in enumerate(batch):
            r.context_len = ctx[i]
            r.last_token = host[i]
        # park the final state in the step slot and flush it, so page
        # caches include this round's appended KV — a later round (or
        # step) over the same residents rebuilds losslessly
        self._install_step(batch, state, tokens)
        self._invalidate_step()
        return out

    # ------------------------------------------------- memory-pressure
    @property
    def occupancy(self) -> float:
        """KV-pool occupancy fraction (allocated + reserved over
        capacity) — the signal memory-pressure preemption triggers on."""
        s = self.pool.stats
        return s.in_use / max(s.capacity, 1)

    def swap_out(self, request_id: str) -> SwappedKV | None:
        """Preempt a resident: copy its full KV — pulled AND decode-
        appended pages — out of the slab, free its blocks, and remove it
        from the batch.  Returns the host-memory entry (None if the
        request isn't resident).  The request stays DECODING; it is
        simply not stepped until ``swap_in`` restores it, so the token
        stream pauses and resumes byte-identically (the pages round-trip
        to host memory in the slab's dtype, unchanged)."""
        r = self.resident.get(request_id)
        if r is None:
            return None
        self._invalidate_step()  # flush appended KV into the page cache
        k, v = self._resident_pages(r)
        del self.resident[request_id]
        self._free_blocks(r.blocks)
        r.req.decode_blocks = []
        if self.metrics is not None:
            self.metrics.inc("fleet.swapped_out")
        return SwappedKV(r.req, k.cpu(), v.cpu(), r.context_len, r.last_token)

    def swap_in(self, entry: SwappedKV) -> bool:
        """Restore a swapped-out request into this worker's batch: land
        its pages back in the slab (so later prefix retention and delta
        grafts read real bytes), allocate fresh blocks, and re-insert the
        resident with its page cache intact.  False when the pool can't
        hold it yet (caller retries when capacity returns).  Restoring on
        a DIFFERENT worker than the one that swapped it out is legal —
        the entry is worker-agnostic (see ``SwappedKV``)."""
        pages = int(entry.k_pages.shape[1])
        if not self.pool.can_allocate(pages) and not self._evict_prefixes(pages):
            return False
        blocks = self.pool.allocate(pages)
        k = entry.k_pages.to(self.device)
        v = entry.v_pages.to(self.device)
        self.cache.write_blocks(blocks, k, v)
        req = entry.req
        req.decode_blocks = blocks
        req.decode_worker = self.info.worker_id
        self.resident[req.request_id] = _Resident(
            req, blocks, entry.context_len, entry.last_token,
            k_cached=k, v_cached=v,
            cached_from=tuple(blocks))
        if self.metrics is not None:
            self.metrics.inc("fleet.swapped_in")
        return True

    def evict_resident(self, request_id: str) -> bool:
        """Sacrifice a resident under memory pressure: drop its decode-
        side KV entirely (blocks freed, batch membership removed).  The
        serving layer replays it via truncate-and-replay (PR 5's
        ``_restart``) — decode is deterministic, so the replay regenerates
        the identical stream."""
        r = self.resident.pop(request_id, None)
        if r is None:
            return False
        self._invalidate_step()  # survivors keep their appended pages
        self._free_blocks(r.blocks)
        r.req.decode_blocks = []
        return True

    # ------------------------------------------------------------ finish
    def finish(self, req_id: str) -> None:
        r = self.resident.pop(req_id, None)
        if r is not None:
            self._retain_prefix(r)
            self._free_blocks(r.blocks)
            # retire the engine's per-request byte counters here too, so
            # legacy callers driving finish() directly (no serving-layer
            # completion) don't grow one entry per request served
            self.engine.pulled_bytes(req_id, pop=True)
            self.engine.reused_bytes(req_id, pop=True)
            r.req.to(RequestState.DONE)

    # ------------------------------------------------------ prefix cache
    def _free_blocks(self, blocks: list[int]) -> list[int]:
        """The ONLY free path for decode-side blocks: release through the
        pool and purge the hash-dedup index for every block that actually
        left the pool.  Shared blocks that merely decrement stay indexed
        — their bytes are still resident and still graftable."""
        released = self.pool.free(blocks)
        for blk in released:
            h = self._block_hash.pop(blk, None)
            if h is not None:
                self._hash_index.pop(h, None)
        return released

    def _register_hashes(self, req: Request) -> None:
        """Index a promoted request's landed blocks by prefill content
        hash (first holder wins — re-registering a grafted block under
        the same hash is a no-op).  Never called for in-flight pulls:
        indexing a block whose bytes haven't landed would graft garbage.

        Quantized-transfer note: the slab holds DEQUANTIZED bytes, not
        the prefill bytes the hash was computed over — still sound,
        because equal prefill bytes quantize to equal wire bytes and
        scales, so a hash hit serves exactly what the new request's own
        quantized pull would have landed."""
        for blk, h in zip(req.decode_blocks, req.block_hashes):
            if h not in self._hash_index:
                self._hash_index[h] = blk
                self._block_hash[blk] = h

    def _retain_prefix(self, r: _Resident) -> None:
        """Keep a finishing request's shared-prefix blocks refcounted in
        the pool (bounded LRU) so prefix-affinity routing can steer the
        next request with the same prefix here."""
        req = r.req
        if not req.prefix_id or self.prefix_cache_cap <= 0:
            return
        if req.prefix_id in self.prefix_cache:
            self.prefix_cache.move_to_end(req.prefix_id)
            return
        prefix_len = req.prefix_len or req.prompt_len
        blocks = r.blocks[: prefix_len // self.block_size]  # whole blocks
        if not blocks:
            return
        self.pool.share(blocks)  # cache's refcount survives the free below
        self.prefix_cache[req.prefix_id] = list(blocks)
        while len(self.prefix_cache) > self.prefix_cache_cap:
            _, evicted = self.prefix_cache.popitem(last=False)
            self._free_blocks(evicted)

    def _evict_prefixes(self, need: int) -> bool:
        """Free retained prefixes (LRU-first) until ``need`` blocks fit;
        True if they now do."""
        while self.prefix_cache and not self.pool.can_allocate(need):
            _, blocks = self.prefix_cache.popitem(last=False)
            self._free_blocks(blocks)
        return self.pool.can_allocate(need)

    @property
    def resident_prefix_blocks(self) -> tuple[tuple[str, int], ...]:
        """(prefix_id, whole blocks retained) pairs, sorted — advertised
        through ``LoadReport.prefix_blocks`` so the router can price a
        delta pull (only the suffix moves) instead of a full pull."""
        return tuple(sorted(
            (pid, len(blocks)) for pid, blocks in self.prefix_cache.items()))

    @property
    def evictable_blocks(self) -> int:
        """Blocks reclaimable from the prefix retention cache (upper
        bound: shared blocks only free once every holder releases)."""
        return sum(len(b) for b in self.prefix_cache.values())

    @property
    def known_prefixes(self) -> frozenset[str]:
        """Prefix ids resident on this worker (live requests, in-flight
        pulls, and the retention cache) — reported via LoadReport."""
        ids = {r.req.prefix_id for r in self.resident.values() if r.req.prefix_id}
        ids.update(fl.req.prefix_id for fl in self.inflight.values()
                   if fl.req.prefix_id)
        ids.update(self.prefix_cache)
        return frozenset(ids)
