"""Tensor-centric transfer descriptors (KVDirect §4.1).

The heart of KVDirect is that the *prefill* worker describes its KV cache
tensor ONCE at connection time — ``(Address, Dims, Shape, Stride)`` — and
from then on the *decode* worker computes every remote byte range locally
(an index·stride dot product) and issues one-sided reads.  No per-block
metadata round trips, no remote-side gather kernels.

This module implements that arithmetic exactly as §4.1 specifies,
including the paper's worked example (see ``TensorDesc`` docstring).
Note: the paper's printed example contains two small arithmetic typos
(147453 B should be 147456 B; the span product is 16·256·2 B, not
16·128·2 B) — the *results* it states (two disjoint 8192 B spans per
block) are what the correct math yields and what we compute here.

Copy of ``src/repro/core/descriptors.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence

__all__ = [
    "ByteRange",
    "TensorDesc",
    "ReadTxn",
    "CompleteTxn",
    "Txn",
    "build_block_reads",
]


@dataclasses.dataclass(frozen=True, order=True)
class ByteRange:
    """A contiguous byte range inside one worker's registered memory."""

    offset: int
    nbytes: int

    def __post_init__(self) -> None:
        if self.offset < 0 or self.nbytes <= 0:
            raise ValueError(f"invalid range: offset={self.offset} nbytes={self.nbytes}")

    @property
    def end(self) -> int:
        return self.offset + self.nbytes

    def abuts(self, other: "ByteRange") -> bool:
        """True if ``other`` starts exactly where this range ends."""
        return self.end == other.offset

    def merged(self, other: "ByteRange") -> "ByteRange":
        if not self.abuts(other):
            raise ValueError(f"cannot merge non-adjacent ranges {self} and {other}")
        return ByteRange(self.offset, self.nbytes + other.nbytes)


@dataclasses.dataclass(frozen=True)
class TensorDesc:
    """Metadata exchanged by ``CONNECT()`` describing one remote tensor.

    Mirrors Figure 5 of the paper.  ``dims`` names each dimension (the
    canonical paged-KV layout is ``("B","KV","L","H","D")`` = blocks,
    K-or-V, tokens-per-block, heads, head-dim, but any order is allowed —
    strides carry the layout).  ``stride`` is in ELEMENTS, ``itemsize``
    in bytes, matching the paper's ``× 2B`` bfloat16 factor.

    Worked example (paper §4.1)::

        >>> d = TensorDesc(address=0x7F06F40000,
        ...                dims=("B", "KV", "L", "H", "D"),
        ...                shape=(10, 2, 16, 2, 128),
        ...                stride=(4096, 40960, 256, 128, 1),
        ...                itemsize=2)
        >>> [r.offset - d.address for r in d.block_ranges(8)]  # K then V of block 8
        [65536, 147456]
        >>> {r.nbytes for r in d.block_ranges(8)}           # one 8192 B span each
        {8192}
    """

    address: int
    dims: tuple[str, ...]
    shape: tuple[int, ...]
    stride: tuple[int, ...]
    itemsize: int
    worker_id: str = ""
    tensor_id: str = ""

    def __post_init__(self) -> None:
        if not (len(self.dims) == len(self.shape) == len(self.stride)):
            raise ValueError("dims/shape/stride rank mismatch")
        if len(set(self.dims)) != len(self.dims):
            raise ValueError(f"duplicate dim names in {self.dims}")
        if any(s <= 0 for s in self.shape):
            raise ValueError(f"non-positive extent in shape {self.shape}")
        if any(s <= 0 for s in self.stride):
            raise ValueError(f"non-positive stride in {self.stride}")
        if self.itemsize <= 0:
            raise ValueError("itemsize must be positive")

    # ------------------------------------------------------------------
    # §4.1 offset arithmetic
    # ------------------------------------------------------------------
    def axis(self, dim: str) -> int:
        try:
            return self.dims.index(dim)
        except ValueError:
            raise KeyError(f"tensor {self.tensor_id!r} has no dim {dim!r} (dims={self.dims})")

    def element_offset(self, index: Sequence[int]) -> int:
        """index · stride — the dot product of §4.1."""
        if len(index) != len(self.shape):
            raise ValueError("index rank mismatch")
        for i, (ix, ext) in enumerate(zip(index, self.shape)):
            if not (0 <= ix < ext):
                raise IndexError(f"index {ix} out of range for dim {self.dims[i]} (extent {ext})")
        return sum(i * s for i, s in zip(index, self.stride))

    def byte_offset(self, index: Sequence[int]) -> int:
        return self.element_offset(index) * self.itemsize

    def _layout_order(self) -> list[int]:
        """Axes sorted by stride, descending (outermost-in-memory first)."""
        return sorted(range(len(self.dims)), key=lambda a: self.stride[a], reverse=True)

    def contiguous_span(self, cover: Sequence[str]) -> int:
        """Bytes of the contiguous span covering dims ``cover`` (§4.1).

        The paper: "find the dimension with the largest stride [among the
        covered dims] and multiply its shape with the stride".  Valid only
        if the covered dims are densely packed (innermost stride 1, each
        outer covered stride equals the span of the dims inside it) —
        verified here, because a silent violation would corrupt transfers.
        """
        axes = sorted((self.axis(d) for d in cover), key=lambda a: self.stride[a])
        span = 1  # elements
        for a in axes:
            if self.stride[a] != span:
                raise ValueError(
                    f"dims {tuple(cover)} of {self.tensor_id!r} are not densely packed: "
                    f"dim {self.dims[a]} stride {self.stride[a]} != inner span {span}"
                )
            span *= self.shape[a]
        return span * self.itemsize

    def block_ranges(self, block_id: int, *, block_dim: str = "B") -> list[ByteRange]:
        """All byte ranges holding block ``block_id``, smallest offset first.

        One range per combination of the non-block, non-inner dims (for the
        canonical layout: one for K, one for V).  The inner contiguous unit
        is the maximal dense suffix below ALL enumerated dims.

        Ranges are ABSOLUTE (``address`` + relative offset) — ready to post
        as RDMA transactions against the worker's registered MR.
        """
        b_axis = self.axis(block_dim)
        order = self._layout_order()
        # Maximal dense suffix (in layout order) that excludes block_dim.
        inner: list[int] = []
        span = 1
        for a in reversed(order):
            if a == b_axis or self.stride[a] != span:
                break
            inner.append(a)
            span *= self.shape[a]
        if not inner:
            raise ValueError(f"tensor {self.tensor_id!r} has no dense inner dims below {block_dim!r}")
        enumerated = [a for a in order if a != b_axis and a not in inner]
        span_bytes = span * self.itemsize

        ranges: list[ByteRange] = []
        for combo in itertools.product(*(range(self.shape[a]) for a in enumerated)):
            index = [0] * len(self.shape)
            index[b_axis] = block_id
            for a, v in zip(enumerated, combo):
                index[a] = v
            ranges.append(ByteRange(self.address + self.byte_offset(index), span_bytes))
        ranges.sort()
        return ranges

    @property
    def nbytes(self) -> int:
        """Total registered bytes (assuming a dense layout overall)."""
        order = self._layout_order()
        top = order[0]
        return self.stride[top] * self.shape[top] * self.itemsize


# ----------------------------------------------------------------------
# Transactions (consumed by core.transactions / core.transfer_engine)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReadTxn:
    """One-sided read: pull ``remote`` on ``src_worker`` into ``local`` on
    ``dst_worker``.  Posted by the decode worker; the prefill worker does
    no work (§4.1 Fig. 7b).

    ``layer`` optionally tags which model layer this read belongs to:
    layer-streamed pulls submit layer 0 first and the engine reports
    per-layer completion on the request's ``TransferFuture``.

    ``qscale`` optionally carries a symmetric-int8 dequantization scale
    for this read's span: the source side computed ``scale =
    max(|span|)/127`` at park time, the wire moves int8 payload
    (``nbytes // 2`` plus the 4-byte scale the descriptor already
    carries), and the engine dequantizes into the destination slab.
    ``None`` = uncompressed (plain byte copy)."""

    request_id: str
    src_worker: str
    dst_worker: str
    remote: ByteRange
    local: ByteRange
    layer: int | None = None
    qscale: float | None = None

    def __post_init__(self) -> None:
        if self.remote.nbytes != self.local.nbytes:
            raise ValueError("read size mismatch between remote and local ranges")
        if self.qscale is not None and self.qscale <= 0:
            raise ValueError(f"qscale must be positive, got {self.qscale}")

    @property
    def nbytes(self) -> int:
        return self.remote.nbytes


@dataclasses.dataclass(frozen=True)
class CompleteTxn:
    """COMPLETE(): tells the prefill worker that ``request_id`` has been
    fully pulled so its KV blocks can be freed (§4.2, synchronous via ACK)."""

    request_id: str
    src_worker: str
    dst_worker: str


Txn = ReadTxn | CompleteTxn


def build_block_reads(
    request_id: str,
    remote_desc: TensorDesc,
    local_desc: TensorDesc,
    remote_blocks: Sequence[int],
    local_blocks: Sequence[int],
    *,
    block_dim: str = "B",
    layer: int | None = None,
    scales: Sequence[Sequence[float]] | None = None,
) -> Iterator[ReadTxn]:
    """TRANSFER(): translate (remote block id → local block id) pairs into
    read transactions using only descriptor arithmetic — the decode worker
    never asks the prefill worker where anything lives.

    ``scales`` (optional) requests quantized transfer: ``scales[i][pos]``
    is the int8 dequantization scale for block position ``i``'s plane
    ``pos`` (K = 0, V = 1 in the canonical layout), attached to the
    emitted ``ReadTxn.qscale`` so the scale rides the descriptor — no
    side channel on the wire.
    """
    if len(remote_blocks) != len(local_blocks):
        raise ValueError("remote/local block list length mismatch")
    if scales is not None and len(scales) != len(remote_blocks):
        raise ValueError("scales/block list length mismatch")
    per_block: list[tuple[list[ByteRange], list[ByteRange]]] = []
    for rb, lb in zip(remote_blocks, local_blocks):
        remote_ranges = remote_desc.block_ranges(rb, block_dim=block_dim)
        local_ranges = local_desc.block_ranges(lb, block_dim=block_dim)
        if [r.nbytes for r in remote_ranges] != [r.nbytes for r in local_ranges]:
            raise ValueError(
                f"block layout mismatch between {remote_desc.tensor_id!r} and "
                f"{local_desc.tensor_id!r} for blocks {rb}->{lb}"
            )
        per_block.append((remote_ranges, local_ranges))
    # Plane-major emission: all K-plane ranges (block order), then all
    # V-plane ranges.  Consecutive blocks land FIFO-adjacent in each plane,
    # so the engine's in-order coalescer (§4.2) sees the paper's
    # "blocks 0 and 1 merge into one 16384 B transaction" opportunity.
    n_ranges = len(per_block[0][0]) if per_block else 0
    for pos in range(n_ranges):
        for i, (remote_ranges, local_ranges) in enumerate(per_block):
            yield ReadTxn(
                request_id=request_id,
                src_worker=remote_desc.worker_id,
                dst_worker=local_desc.worker_id,
                remote=remote_ranges[pos],
                local=local_ranges[pos],
                layer=layer,
                qscale=None if scales is None else float(scales[i][pos]),
            )
