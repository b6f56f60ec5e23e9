"""Read-transaction coalescing (KVDirect §4.2).

"KVDirect pops all the read transactions in order until the first
completion transaction for the coalescing opportunity. [...] A group of
transactions can be merged only when the results of both remote and local
locations are contiguous."

Small paged-KV blocks (KBs) cannot saturate a 400 Gbps NIC / an ICI link;
merging adjacent blocks into one DMA descriptor is where the paper's
Fig. 17 speedup (1.13×/1.03×, up to 1.32× at high QPS) comes from.

Two strategies are provided:

* ``coalesce_fifo`` — the paper's strategy: scan the window in FIFO order
  and merge runs that happen to be adjacent.  Faithful baseline.
* ``coalesce_sorted`` — a beyond-paper improvement (§Perf in
  EXPERIMENTS.md): sort the window by (src, dst, remote offset) first so
  non-FIFO-adjacent but memory-adjacent transactions also merge, then
  restore no ordering (reads within a request are order-free — only
  COMPLETE is ordered, which the window boundary already guarantees).

Copy of ``src/repro/core/coalesce.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.core.descriptors import ByteRange, ReadTxn

__all__ = ["CoalescedRead", "coalesce_fifo", "coalesce_sorted", "coalesce"]


@dataclasses.dataclass(frozen=True)
class CoalescedRead:
    """One RDMA-level read covering >=1 original transactions.

    ``qscale`` is the int8 dequantization scale carried over from a
    quantized ``ReadTxn``.  A scale is per-span, so quantized reads never
    merge with neighbours (each keeps its own scale) — see ``_mergeable``.
    """

    src_worker: str
    dst_worker: str
    remote: ByteRange
    local: ByteRange
    request_ids: tuple[str, ...]
    qscale: float | None = None

    @property
    def nbytes(self) -> int:
        return self.remote.nbytes

    @property
    def n_merged(self) -> int:
        return len(self.request_ids)


def _mergeable(acc: CoalescedRead, txn: ReadTxn) -> bool:
    # quantized spans carry one scale each: merging two would lose a
    # scale, so a qscale on either side blocks the merge
    return (
        acc.qscale is None
        and txn.qscale is None
        and acc.src_worker == txn.src_worker
        and acc.dst_worker == txn.dst_worker
        and acc.remote.abuts(txn.remote)
        and acc.local.abuts(txn.local)
    )


def _fold(txns: Iterable[ReadTxn]) -> list[CoalescedRead]:
    out: list[CoalescedRead] = []
    for t in txns:
        if out and _mergeable(out[-1], t):
            prev = out[-1]
            out[-1] = CoalescedRead(
                src_worker=prev.src_worker,
                dst_worker=prev.dst_worker,
                remote=prev.remote.merged(t.remote),
                local=prev.local.merged(t.local),
                request_ids=prev.request_ids + (t.request_id,),
            )
        else:
            out.append(
                CoalescedRead(
                    src_worker=t.src_worker,
                    dst_worker=t.dst_worker,
                    remote=t.remote,
                    local=t.local,
                    request_ids=(t.request_id,),
                    qscale=t.qscale,
                )
            )
    return out


def coalesce_fifo(window: Sequence[ReadTxn]) -> list[CoalescedRead]:
    """Paper-faithful: merge only FIFO-adjacent, memory-adjacent reads."""
    return _fold(window)


def coalesce_sorted(window: Sequence[ReadTxn]) -> list[CoalescedRead]:
    """Beyond-paper: sort by (pair, remote offset, local offset) before
    folding, exposing every adjacency in the window, not just FIFO runs."""
    key = lambda t: (t.src_worker, t.dst_worker, t.remote.offset, t.local.offset)
    return _fold(sorted(window, key=key))


def coalesce(window: Sequence[ReadTxn], *, strategy: str = "fifo") -> list[CoalescedRead]:
    if strategy == "fifo":
        return coalesce_fifo(window)
    if strategy == "sorted":
        return coalesce_sorted(window)
    if strategy == "none":
        return [
            CoalescedRead(t.src_worker, t.dst_worker, t.remote, t.local,
                          (t.request_id,), qscale=t.qscale)
            for t in window
        ]
    raise ValueError(f"unknown coalescing strategy {strategy!r}")
