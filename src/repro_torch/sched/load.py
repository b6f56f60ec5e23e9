"""Per-worker load telemetry, piggybacked on the cluster heartbeat.

KVDirect keeps the control plane deliberately tiny (§4.2): workers only
talk to the scheduler for membership and liveness.  The router needs
per-worker occupancy to make placement decisions, so rather than adding a
second control channel we attach a ``LoadReport`` to the heartbeat the
worker already sends — ``ClusterScheduler.heartbeat(wid, now, load=...)``
stores the latest report next to the liveness timestamp, and the router
reads it back through ``ClusterScheduler.load()``.

``modeled_transfer_s`` is the NetKV-style cost the network-aware policy
minimizes: the modeled time to move a request's KV footprint over a
specific decode worker's link, using the SAME ``LinkModel`` the transfer
engine accrues — so routing scores and engine timing cannot drift apart.

Copy of ``src/repro/sched/load.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.transfer_engine import KVDIRECT_UTIL, LinkModel

__all__ = ["LoadReport", "modeled_transfer_s"]


@dataclasses.dataclass(frozen=True)
class LoadReport:
    """One worker's occupancy snapshot, as of heartbeat time ``t``.

    Capacity is counted in KV blocks (the unit both worker roles
    allocate); ``queued_tokens`` is work accepted but not yet running —
    prefill queue depth for prefill workers, KV_QUEUED footprint for
    decode workers.
    """

    worker_id: str
    role: str  # "prefill" | "decode"
    free_blocks: int
    total_blocks: int
    resident_requests: int = 0
    queued_tokens: int = 0
    queue_depth: int = 0
    block_size: int = 32
    t: float = 0.0
    # Shared-prefix ids this worker currently holds resident (live
    # requests, in-flight pulls, and the BlockPool-refcounted retention
    # cache) — the signal the "prefix_affinity" policy routes on.
    prefix_ids: tuple[str, ...] = ()
    # Blocks held only by the prefix retention cache: NOT free (they
    # count as load for placement) but reclaimable on demand, so
    # admission planning may spend them (the worker evicts lazily).
    evictable_blocks: int = 0
    # Resident-set advertisement for delta transfer (docs/scheduling.md):
    # (prefix_id, whole blocks retained) per cached prefix.  The router
    # prices a pull to this worker as suffix-only — the resident prefix
    # blocks are grafted decode-side, never moved — and admission
    # planning charges only the suffix against the worker's budget.
    prefix_blocks: tuple[tuple[str, int], ...] = ()

    def resident_blocks_for(self, prefix_id: str | None) -> int:
        """Whole prefix blocks this worker retains for ``prefix_id``
        (0 when unknown) — the wire savings a delta plan realizes here."""
        if prefix_id is None:
            return 0
        for pid, nblocks in self.prefix_blocks:
            if pid == prefix_id:
                return nblocks
        return 0

    @property
    def queued_blocks(self) -> int:
        return -(-self.queued_tokens // max(self.block_size, 1))

    @property
    def load_fraction(self) -> float:
        """In-use plus queued demand, as a fraction of capacity."""
        used = self.total_blocks - self.free_blocks + self.queued_blocks
        return used / max(self.total_blocks, 1)


def modeled_transfer_s(
    kv_bytes: int,
    link: LinkModel,
    *,
    span_bytes: int = 64 * 1024,
    coalesce_factor: float = 8.0,
    utilization: float = KVDIRECT_UTIL,
) -> float:
    """Modeled pull time for ``kv_bytes`` of KV over ``link``.

    ``span_bytes`` is one K-or-V span of a block (one read transaction);
    ``coalesce_factor`` is the average spans-per-RDMA-op the engine
    achieves (§4.2 coalescing).  Post overheads scale with ops, wire time
    with bytes at the link's effective utilization, and the link's
    propagation latency is charged once per pull (pipelined reads mean
    only the first byte pays it) — on a cross-region link this term can
    dominate small deltas, which is exactly what topology-aware routing
    needs to see (docs/topology.md).
    """
    if kv_bytes <= 0:
        return 0.0
    n_spans = -(-kv_bytes // max(span_bytes, 1))
    n_ops = max(1, int(n_spans / max(coalesce_factor, 1.0)))
    return (n_ops * link.post_overhead_s + link.latency_s
            + kv_bytes / (utilization * link.bandwidth_Bps))
