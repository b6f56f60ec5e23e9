"""The mesh context of the model code, and the collectives it runs — the
port of ``src/repro/models/sharding.py``.

The reference asks XLA for layouts (``constrain``, ``shard_*``) and lets
its partitioner insert the collectives.  Eager PyTorch has no partitioner,
so the port's model code holds local shards and calls the collectives
themselves, over a named mesh axis: ``all_reduce`` (sum or max),
``all_gather`` and ``all_to_all`` (both tiled, as ``jax.lax``'s with
``tiled=True``).  With no mesh set, or over an axis of size 1, every one
is a no-op that returns its input, as the reference's helpers are.

Every collective that runs is recorded in ``COUNTER`` (kind, dtype, shape
and group size; ``launch.hlo_analysis.collective_stats`` prices the
records with the reference's wire model).  The shape recorded is the
rank's result, as an HLO op's shape is: the gathered tensor of an
all-gather, the tensor itself for the others.

Also the reference's GQA policy:
  * heads divisible by TP → shard heads;
  * else if kv-groups divisible → shard groups;
  * else leave attention unsharded on heads (batch DP still applies).

On a ``gloo`` mesh (ranks that share one card, or the CPU) a collective
over CUDA tensors goes through host copies in pinned memory: gloo moves
host memory.  The mesh chose its backend when it was made
(``launch/mesh.py``); nothing here switches backends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = [
    "set_mesh", "get_mesh", "mesh_context", "dp_axes", "tp_size", "dp_size",
    "tp_folded", "axis_size", "axis_index", "heads_sharded",
    "all_reduce", "all_gather", "all_to_all", "take_shard", "MeshLayout",
    "CollectiveRecord", "CollectiveCounter", "COUNTER",
]

_STATE: dict = {"mesh": None, "dp": ("data",), "tp_folded": False}


def set_mesh(mesh, *, fold_model_axis: bool = False) -> None:
    """fold_model_axis=True: the 'model' axis joins data parallelism
    (DP+EP deployment for archs whose dims can't use TP — see
    ModelConfig.fold_model_axis_into_dp)."""
    _STATE["mesh"] = mesh
    _STATE["tp_folded"] = fold_model_axis
    if mesh is not None:
        dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
        if fold_model_axis and "model" in mesh.shape:
            dp = dp + ("model",)
        _STATE["dp"] = dp


def tp_folded() -> bool:
    return _STATE["tp_folded"]


@contextlib.contextmanager
def mesh_context(mesh, *, fold_model_axis: bool = False):
    prev = (_STATE["mesh"], _STATE["tp_folded"])
    set_mesh(mesh, fold_model_axis=fold_model_axis)
    try:
        yield
    finally:
        set_mesh(prev[0], fold_model_axis=prev[1])


def get_mesh():
    return _STATE["mesh"]


def dp_axes() -> tuple[str, ...]:
    return _STATE["dp"]


def tp_size() -> int:
    mesh = get_mesh()
    if mesh is None or _STATE["tp_folded"]:
        return 1
    return mesh.shape.get("model", 1)


def dp_size() -> int:
    mesh = get_mesh()
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in dp_axes())


def axis_size(axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names): 1 without a mesh
    or for an axis the mesh lacks."""
    mesh = get_mesh()
    if mesh is None:
        return 1
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.shape.get(a, 1) for a in names)


def axis_index(axes) -> int:
    """This rank's index along ``axes``, row-major over a tuple of names."""
    mesh = get_mesh()
    if mesh is None:
        return 0
    idx = 0
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        idx = idx * mesh.shape.get(a, 1) + mesh.coords.get(a, 0)
    return idx


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0 and dim >= size


def heads_sharded(num_heads: int) -> bool:
    """The GQA policy: query heads (or kv groups, a divisor of them) shard
    over TP when they divide it."""
    return _fits(num_heads, tp_size())


def take_shard(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim``, split over ``axes``
    (a view; no communication)."""
    n = axis_size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(axes) * size, size)


# ---------------------------------------------------------------- layout
@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """How a decode state's tensors are split over the mesh: the batch dim
    over ``batch_axes`` jointly, and (``seq_parallel``) the pages' per_seq
    dim over 'model' — the sequence-parallel flash-decoding layout of
    ``launch.shardings.decode_state_sharding``."""

    batch_axes: tuple[str, ...] = ()
    seq_parallel: bool = False


# --------------------------------------------------------------- counter
@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    kind: str                 # "all-reduce" | "all-gather" | "all-to-all" (HLO's names)
    dtype: torch.dtype
    shape: tuple[int, ...]    # the rank's result
    group_size: int
    axis: str

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * torch.empty((), dtype=self.dtype).element_size()


class CollectiveCounter:
    """Every collective the model code ran since the last ``reset()``, in
    order (the records, a plain list, like the kernels' launch counts)."""

    def __init__(self):
        self.records: list[CollectiveRecord] = []

    def reset(self) -> None:
        self.records = []

    def add(self, kind: str, x: torch.Tensor, group_size: int, axis: str) -> None:
        self.records.append(CollectiveRecord(kind, x.dtype, tuple(x.shape), group_size, axis))

    def summary(self) -> dict[str, dict[str, int]]:
        """{kind: {"count": n, "bytes": b}} over the records."""
        out: dict[str, dict[str, int]] = {}
        for r in self.records:
            s = out.setdefault(r.kind, {"count": 0, "bytes": 0})
            s["count"] += 1
            s["bytes"] += r.nbytes
        return out


COUNTER = CollectiveCounter()


# ----------------------------------------------------------- collectives
def _group(axis: str):
    mesh = get_mesh()
    return mesh.groups[axis], mesh.backend


def _via_host(x: torch.Tensor, backend: str) -> bool:
    return backend == "gloo" and x.is_cuda


def _buffer(like: torch.Tensor, host: bool) -> torch.Tensor:
    """An empty tensor of ``like``'s shape and dtype: in pinned host memory
    when the collective goes through the host, else beside ``like``."""
    if host:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like)


def _to_wire(x: torch.Tensor, backend: str) -> torch.Tensor:
    """The tensor the backend moves: gloo moves host memory."""
    x = x.contiguous()
    return _buffer(x, True).copy_(x) if _via_host(x, backend) else x


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of ``x`` over the ranks of ``axes``; a new tensor.
    Over a tuple of axes, one reduction per axis."""
    if isinstance(axes, tuple):
        for a in axes:
            x = all_reduce(x, a, op)
        return x
    n = axis_size(axes)
    if n == 1:
        return x
    group, backend = _group(axes)
    buf = _to_wire(x, backend)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=group)
    COUNTER.add("all-reduce", buf, n, axes)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axes`` concatenated along ``dim`` in rank
    order (tiled); over a tuple of axes, row-major (the last axis gathered
    first)."""
    if isinstance(axes, tuple):
        for a in reversed(axes):
            x = all_gather(x, a, dim)
        return x
    n = axis_size(axes)
    if n == 1:
        return x
    group, backend = _group(axes)
    buf = _to_wire(x, backend)
    parts = [_buffer(buf, _via_host(x, backend)) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat([p.to(x.device) for p in parts], dim=dim)
    COUNTER.add("all-gather", out, n, axes)
    return out


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``x`` cut into as many chunks along ``split_dim`` as ``axis`` has
    ranks, chunk j sent to rank j, the chunks received concatenated along
    ``concat_dim`` in source order (``jax.lax.all_to_all(..., tiled=True)``)."""
    n = axis_size(axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    group, backend = _group(axis)
    send = _to_wire(torch.stack(x.chunk(n, dim=split_dim)), backend)
    recv = _buffer(send, _via_host(x, backend))
    dist.all_to_all_single(recv, send, group=group)
    COUNTER.add("all-to-all", x, n, axis)
    return torch.cat([r.to(x.device) for r in recv.unbind(0)], dim=concat_dim % x.dim())
