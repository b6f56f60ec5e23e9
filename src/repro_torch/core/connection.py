"""CONNECT() — connection establishment and descriptor exchange (§4.2).

The handshake: a decode worker connects to a prefill worker, and the
prefill worker replies with the ``TensorDesc`` of every registered KV
tensor (Fig. 5).  From then on the decode worker computes remote offsets
locally; the prefill worker is never on the data-plane critical path.

Link alignment: chip *i* of a decode worker only connects to chip *i* of
a prefill worker (§4.2: "GPU i of a decode worker can only connect with
GPU i of a prefill worker" — datacenter rail topology).  On TPU the same
constraint keeps pulls on disjoint ICI paths: decode chip at position
(x, y) of its slice pulls from prefill chip at position (x, y).

Connections carry an *epoch*: when a prefill worker dies and rejoins, its
addresses are invalid; stale descriptors must never be dereferenced.  Any
transfer built against epoch E is rejected if the connection has moved on.

Copy of ``src/repro/core/connection.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.descriptors import TensorDesc

__all__ = ["ChipInfo", "WorkerInfo", "DescriptorRegistry", "Connection", "ConnectionManager"]


@dataclasses.dataclass(frozen=True)
class ChipInfo:
    chip_id: int
    link_addr: str  # e.g. "192.168.0.132" (paper) or "ici://pod0/x3y7"


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    worker_id: str
    role: str  # "prefill" | "decode"
    host_addr: str
    chips: tuple[ChipInfo, ...]

    def __post_init__(self) -> None:
        if self.role not in ("prefill", "decode"):
            raise ValueError(f"bad role {self.role!r}")


class DescriptorRegistry:
    """Prefill-side: the tensors this worker is willing to serve reads
    from.  Registered once when the KV cache is allocated; sent verbatim
    during CONNECT."""

    def __init__(self, worker_id: str) -> None:
        self.worker_id = worker_id
        self._descs: dict[str, TensorDesc] = {}

    def register(self, desc: TensorDesc) -> None:
        if desc.worker_id != self.worker_id:
            raise ValueError(f"descriptor worker {desc.worker_id!r} != registry {self.worker_id!r}")
        self._descs[desc.tensor_id] = desc

    def snapshot(self) -> dict[str, TensorDesc]:
        return dict(self._descs)


@dataclasses.dataclass
class Connection:
    decode_worker: str
    prefill_worker: str
    epoch: int
    chip_pairs: tuple[tuple[int, int], ...]  # (decode chip, prefill chip) — link aligned
    descriptors: dict[str, TensorDesc]

    def desc(self, tensor_id: str) -> TensorDesc:
        try:
            return self.descriptors[tensor_id]
        except KeyError:
            raise KeyError(
                f"connection {self.decode_worker}->{self.prefill_worker} (epoch {self.epoch}) "
                f"has no tensor {tensor_id!r}"
            )


class ConnectionManager:
    """Decode-side connection table.  One entry per live prefill worker.

    The decode worker — not the cluster scheduler — owns this table, so a
    scheduler outage never stalls the data plane (§4.2: "To avoid the
    single-point failure of the scheduler, the decode worker maintains
    the connection of all active prefill workers").
    """

    def __init__(self, worker_info: WorkerInfo) -> None:
        if worker_info.role != "decode":
            raise ValueError("ConnectionManager lives on decode workers")
        self.info = worker_info
        self._conns: dict[str, Connection] = {}
        self._epoch = 0
        self._on_invalidate: list[Callable[[str, int], None]] = []

    # ----------------------------------------------------------- events
    def on_invalidate(self, cb: Callable[[str, int], None]) -> None:
        """cb(prefill_worker_id, dead_epoch) — serving layer re-queues
        requests whose KV descriptors just died."""
        self._on_invalidate.append(cb)

    # ---------------------------------------------------------- connect
    def connect(self, peer: WorkerInfo, registry: DescriptorRegistry) -> Connection:
        """The CONNECT() handshake."""
        if peer.role != "prefill":
            raise ValueError("decode workers only connect to prefill workers")
        if registry.worker_id != peer.worker_id:
            raise ValueError("registry does not belong to peer")
        n = min(len(self.info.chips), len(peer.chips))
        pairs = tuple(
            (self.info.chips[i].chip_id, peer.chips[i].chip_id) for i in range(n)
        )  # link-aligned: i <-> i only
        self._epoch += 1
        conn = Connection(
            decode_worker=self.info.worker_id,
            prefill_worker=peer.worker_id,
            epoch=self._epoch,
            chip_pairs=pairs,
            descriptors=registry.snapshot(),
        )
        self._conns[peer.worker_id] = conn
        return conn

    def disconnect(self, prefill_worker: str, *, failed: bool = False) -> None:
        conn = self._conns.pop(prefill_worker, None)
        if conn is not None and failed:
            for cb in self._on_invalidate:
                cb(prefill_worker, conn.epoch)

    # ------------------------------------------------------------ query
    def connection(self, prefill_worker: str) -> Connection:
        try:
            return self._conns[prefill_worker]
        except KeyError:
            raise KeyError(f"no live connection to {prefill_worker!r}")

    def validate_epoch(self, prefill_worker: str, epoch: int) -> None:
        conn = self.connection(prefill_worker)
        if conn.epoch != epoch:
            raise StaleConnectionError(
                f"transfer built at epoch {epoch} but connection to "
                f"{prefill_worker!r} is at epoch {conn.epoch}"
            )

    @property
    def peers(self) -> tuple[str, ...]:
        return tuple(self._conns)


class StaleConnectionError(RuntimeError):
    pass
