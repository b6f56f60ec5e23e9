"""Pull-mode vs push-mode KV transfer orchestration (§4.3).

Pull-mode (KVDirect's default):
  1. prefill worker allocates blocks, runs ALL layers of prefill;
  2. block IDs travel to the decode worker (tiny control message);
  3. decode worker allocates its blocks only NOW — KV lifetime on the
     decode worker starts here, not at admission;
  4. decode worker pulls every layer's blocks in one shot (one-sided
     reads), then sends COMPLETE; prefill frees on COMPLETE.

Push-mode (the strawman; Splitwise/DéjàVu-style):
  1. decode worker must RESERVE all blocks at admission (pre-allocation —
     required because incremental allocation deadlocks, Motivation #3);
  2. prefill worker pushes layer-by-layer as it computes;
  3. decode memory is held idle from admission until prefill completes.

Both modes are implemented against the real caches + transfer engine so
the byte movement is identical and testable; the *timing/occupancy*
consequences (Fig. 11/16) are accounted by the caller's clock (the event
simulator at cluster scale, the serving driver at CPU scale).

Copy of ``src/repro/core/pull_push.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.connection import Connection
from repro_torch.core.descriptors import CompleteTxn, Txn, build_block_reads
from repro_torch.core.transfer_engine import TransferEngine, TransferFuture, TransferStats
from repro_torch.serving.blocks import BlockPool
from repro_torch.serving.kv_cache import PagedKVCache, SlotCache
from repro_torch.serving.request import Request, RequestState

__all__ = ["pull_kv", "pull_kv_async", "push_reserve", "push_layer", "push_finish",
           "pull_state"]


def _allocate_decode_blocks(
    req: Request, decode_pool: BlockPool, preallocated: list[int] | None
) -> None:
    n = len(req.prefill_blocks)
    if preallocated is not None:
        if len(preallocated) != n:
            raise ValueError(f"need {n} preallocated blocks, got {len(preallocated)}")
        req.decode_blocks = preallocated
    else:
        req.decode_blocks = decode_pool.allocate(n)  # may raise OutOfBlocks


def _pull_txns(
    req: Request,
    conn: Connection,
    decode_cache: PagedKVCache,
    *,
    skip: frozenset[int] | set[int] | None = None,
) -> list[Txn]:
    """Layer-streamed transaction list: layer 0's reads first, every read
    tagged with its layer (per-layer completion lands on the future), a
    single COMPLETE at the tail.

    ``skip`` holds block POSITIONS (indices into ``prefill_blocks`` /
    ``decode_blocks``) a delta transfer plan grafts from blocks already
    resident decode-side — no read is emitted for them, in any layer.
    The COMPLETE still tails the plan: the prefill copy frees once the
    suffix lands (the skipped prefix never needed the prefill copy).

    When the request carries per-block quantization scales
    (``req.kv_scales[layer][position][plane]``, computed at prefill park
    time), each emitted read gets its ``qscale`` so the engine moves int8
    wire bytes and dequantizes with the carried scale."""
    skip = skip or frozenset()
    positions = [i for i in range(len(req.prefill_blocks)) if i not in skip]
    remote_blocks = [req.prefill_blocks[i] for i in positions]
    local_blocks = [req.decode_blocks[i] for i in positions]
    kv_scales = getattr(req, "kv_scales", None)
    txns: list[Txn] = []
    for layer in range(decode_cache.num_layers):
        if not remote_blocks:
            break  # fully resident: nothing to read, COMPLETE only
        remote = conn.desc(f"layer{layer}/kv")
        local = decode_cache.desc(layer)
        scales = None
        if kv_scales is not None:
            scales = [kv_scales[layer][i] for i in positions]
        txns.extend(
            build_block_reads(
                req.request_id, remote, local, remote_blocks,
                local_blocks, layer=layer, scales=scales,
            )
        )
    txns.append(
        CompleteTxn(
            request_id=req.request_id,
            src_worker=conn.prefill_worker,
            dst_worker=conn.decode_worker,
        )
    )
    return txns


def pull_kv(
    req: Request,
    *,
    conn: Connection,
    engine: TransferEngine,
    decode_pool: BlockPool,
    decode_cache: PagedKVCache,
    drain: bool = True,
    preallocated: list[int] | None = None,
) -> TransferStats:
    """Pull-mode transfer of a whole request: allocate decode blocks,
    TRANSFER() every layer's blocks, COMPLETE().

    Raises OutOfBlocks if the decode pool can't hold the request — the
    caller keeps the request in KV_QUEUED (prefill-side KV stays alive;
    the prefill worker is free to compute other requests meanwhile, which
    is exactly pull-mode's utilization win).  Callers that must fail
    BEFORE any request state changes pass ``preallocated`` blocks.
    """
    _allocate_decode_blocks(req, decode_pool, preallocated)
    req.connection_epoch = conn.epoch
    engine.submit(_pull_txns(req, conn, decode_cache))
    return engine.drain() if drain else engine.stats


def pull_kv_async(
    req: Request,
    *,
    conn: Connection,
    engine: TransferEngine,
    decode_pool: BlockPool,
    decode_cache: PagedKVCache,
    preallocated: list[int] | None = None,
    skip: frozenset[int] | set[int] | None = None,
) -> TransferFuture:
    """Non-blocking pull: same allocation contract and byte movement as
    ``pull_kv`` but nothing executes yet — the caller advances the
    transfer with ``engine.progress()`` (interleaved with decode compute)
    and observes completion through the returned future, per layer via
    ``future.layers_done`` and per request via ``future.done()``.

    ``skip`` (delta transfer): block positions already resident on the
    decode worker — grafted into ``decode_blocks`` by the caller, never
    read over the wire.  A fully-resident plan emits ONLY the COMPLETE;
    its future pre-marks every layer done so ``wait_layer`` consumers
    (layer-streamed decode) see the same contract as a real pull."""
    _allocate_decode_blocks(req, decode_pool, preallocated)
    req.connection_epoch = conn.epoch
    engine.submit(_pull_txns(req, conn, decode_cache, skip=skip))
    fut = engine.future(req.request_id)
    assert fut is not None  # just submitted, cannot have resolved
    if skip and len(skip) >= len(req.prefill_blocks):
        # zero reads queued: every layer's bytes are already resident
        fut._layers_done.extend(range(decode_cache.num_layers))
    return fut


def pull_state(
    req: Request,
    *,
    conn: Connection,
    engine: TransferEngine,
    decode_cache: SlotCache,
    remote_slot: int,
    local_slot: int,
    drain: bool = True,
) -> TransferStats:
    """SSM-state pull: one contiguous transaction per layer (degenerate
    best case of the tensor-centric design — see DESIGN.md §4)."""
    txns = []
    for layer in range(decode_cache.num_layers):
        remote = conn.desc(f"layer{layer}/state")
        local = decode_cache.desc(layer)
        txns.extend(
            build_block_reads(req.request_id, remote, local, [remote_slot],
                              [local_slot], layer=layer)
        )
    txns.append(
        CompleteTxn(
            request_id=req.request_id,
            src_worker=conn.prefill_worker,
            dst_worker=conn.decode_worker,
        )
    )
    engine.submit(txns)
    return engine.drain() if drain else engine.stats


# ----------------------------------------------------------------- push
def push_reserve(req: Request, decode_pool: BlockPool, num_blocks: int) -> None:
    """Push-mode step 1: pre-allocate ALL decode blocks at admission.
    This is the memory that sits idle for the whole prefill (Fig. 11a)."""
    req.decode_blocks = decode_pool.reserve(num_blocks)


def push_layer(
    req: Request,
    layer: int,
    *,
    conn: Connection,
    engine: TransferEngine,
    decode_cache: PagedKVCache,
    drain: bool = True,
) -> TransferStats:
    """Push-mode step 2: prefill pushes one finished layer.  On the wire
    this is the same byte movement (our engine copies src→dst); the
    difference is WHO initiates and WHEN memory is held."""
    remote = conn.desc(f"layer{layer}/kv")
    local = decode_cache.desc(layer)
    engine.submit(
        build_block_reads(req.request_id, remote, local, req.prefill_blocks, req.decode_blocks)
    )
    return engine.drain() if drain else engine.stats


def push_finish(
    req: Request,
    *,
    conn: Connection,
    engine: TransferEngine,
    decode_pool: BlockPool,
) -> TransferStats:
    """Push-mode step 3: all layers pushed; commit reservations and
    COMPLETE so the prefill side frees."""
    decode_pool.commit(req.decode_blocks)
    engine.submit(
        [
            CompleteTxn(
                request_id=req.request_id,
                src_worker=conn.prefill_worker,
                dst_worker=conn.decode_worker,
            )
        ]
    )
    return engine.drain()
