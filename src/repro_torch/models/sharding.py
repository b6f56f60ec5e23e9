"""The mesh context of the model code, and the collectives it runs — the
port of ``src/repro/models/sharding.py``.

The reference asks XLA for layouts (``constrain``, ``shard_*``) and lets
its partitioner insert the collectives.  Eager PyTorch has no partitioner,
so the port's model code holds local shards and calls the collectives
themselves, over a named mesh axis: ``all_reduce`` (sum or max),
``all_gather`` and ``all_to_all`` (both tiled, as ``jax.lax``'s with
``tiled=True``).  With no mesh set, or over an axis of size 1, every one
is a no-op that returns its input, as the reference's helpers are.

Every collective that runs is recorded in ``COUNTER`` (kind, dtype, shape,
group size, and whether a forward or a backward ran it;
``launch.hlo_analysis.collective_stats`` prices the records with the
reference's wire model).  The shape recorded is the rank's result, as an
HLO op's shape is: the gathered tensor of an all-gather, this rank's
slice of a reduce-scatter, the tensor itself for the others.

Training under a mesh: the gradient convention.  XLA differentiates the
reference's global program; the port differentiates each rank's local
one, so every collective is an autograd Function whose backward keeps
one convention:

  * **One loss.**  Every rank backpropagates the same global scalar loss,
    the mean over the global batch.  An all-reduce's backward is
    therefore the identity.
  * **Sums only over different contributions.**  A gradient is summed
    over exactly the ranks that saw different data or computed different
    partial values:
      - ``copy_to_model`` (Megatron's "f") sits at the input of every
        column-parallel product: nothing forward, an all-reduce over
        'model' backward, since each model rank holds only its columns'
        part of the replicated input's gradient;
      - ``all_gather``'s backward is a reduce-scatter: the sum over the
        group, this rank's slice kept;
      - ``all_to_all``'s backward is the inverse exchange;
      - ``take_shard``'s backward is autograd's own, through the slice;
      - the ``max`` all-reduce (a loss's shift) takes no gradient;
      - ``share_grad`` marks a value that the ranks of some axes computed
        alike (a loss over a batch replicated over them, a MoE aux loss
        over gathered rows, experts run whole on every model rank): its
        gradient is split evenly among them, so that the sums above
        count it once.
  * **Leaves replicated over a DP axis** (norms, row-parallel biases, the
    router, conv kernels, SSM vectors, ``meta``, and under the folded
    deployment every non-MoE weight along 'model') have their gradients
    summed over those axes after the backward (``launch.steps``); leaves
    that the train placement splits over 'data' (FSDP) come out of the
    reduce-scatter already summed.
  * The backward collectives go through ``COUNTER`` as the forward ones
    do, marked ``backward`` (so are the gradient sums and the norm after
    it, inside ``recording("backward")``); under remat the recomputed
    forward's count as forward (``torch.utils.checkpoint`` stops a
    recompute after the last value the backward needs, so a group's final
    row-parallel sum is not run again).

Also the reference's GQA policy:
  * heads divisible by TP → shard heads;
  * else if kv-groups divisible → shard groups;
  * else leave attention unsharded on heads (batch DP still applies).

On a ``gloo`` mesh (ranks that share one card, or the CPU) a collective
over CUDA tensors goes through host copies in pinned memory: gloo moves
host memory.  gloo has no reduce-scatter: there it is an all-reduce of
the whole tensor and a slice (the record still says reduce-scatter: the
operation the model asked for).  The mesh chose its backend when it was
made (``launch/mesh.py``); nothing here switches backends.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

__all__ = [
    "set_mesh", "get_mesh", "mesh_context", "recording", "dp_axes", "tp_size", "dp_size",
    "tp_folded", "axis_size", "axis_index", "heads_sharded",
    "all_reduce", "all_gather", "all_to_all", "take_shard", "copy_to_model", "share_grad",
    "MeshLayout",
    "CollectiveRecord", "CollectiveCounter", "COUNTER",
]

_STATE: dict = {"mesh": None, "dp": ("data",), "tp_folded": False, "direction": "forward"}


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


@contextlib.contextmanager
def recording(direction: str):
    """Record the collectives run outside autograd's backward in this block
    as ``direction`` (a train step's gradient sums and norm: "backward")."""
    prev = _STATE["direction"]
    _STATE["direction"] = direction
    try:
        yield
    finally:
        _STATE["direction"] = prev


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
    kind: str                 # "all-reduce" | "all-gather" | "all-to-all" | "reduce-scatter"
    dtype: torch.dtype
    shape: tuple[int, ...]    # the rank's result
    group_size: int
    axis: str
    direction: str = "forward"   # or "backward": run by an autograd backward

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

    def add(self, kind: str, x: torch.Tensor, group_size: int, axis: str,
            direction: str | None = None) -> None:
        self.records.append(CollectiveRecord(kind, x.dtype, tuple(x.shape), group_size, axis,
                                             direction or _STATE["direction"]))

    def summary(self, direction: str | None = None) -> dict[str, dict[str, int]]:
        """{kind: {"count": n, "bytes": b}} over the records (of one
        ``direction`` only, when given)."""
        out: dict[str, dict[str, int]] = {}
        for r in self.records:
            if direction is not None and r.direction != direction:
                continue
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


def _all_reduce(x: torch.Tensor, axis: str, op: str, direction: str | None = None
                ) -> torch.Tensor:
    n = axis_size(axis)
    group, backend = _group(axis)
    buf = _to_wire(x, backend)
    if buf is x:
        buf = x.clone()
    dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=group)
    COUNTER.add("all-reduce", buf, n, axis, direction)
    return buf.to(x.device)


def _all_gather(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    n = axis_size(axis)
    group, backend = _group(axis)
    buf = _to_wire(x, backend)
    parts = [_buffer(buf, _via_host(x, backend)) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat([p.to(x.device) for p in parts], dim=dim)
    COUNTER.add("all-gather", out, n, axis)
    return out


def _reduce_scatter(x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, this rank's slice
    along ``dim`` kept (a backward's collective)."""
    n = axis_size(axis)
    group, backend = _group(axis)
    if backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim)
    else:  # gloo: the whole sum, then the slice
        buf = _to_wire(x, backend)
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, group=group)
        size = x.shape[dim] // n
        out = buf.narrow(dim, axis_index(axis) * size, size).to(x.device)
    out = out.contiguous()
    COUNTER.add("reduce-scatter", out, n, axis, "backward")
    return out


def _all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
                direction: str | None = None) -> torch.Tensor:
    n = axis_size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks of {axis!r}")
    group, backend = _group(axis)
    send = _to_wire(torch.stack(x.chunk(n, dim=split_dim)), backend)
    recv = _buffer(send, _via_host(x, backend))
    dist.all_to_all_single(recv, send, group=group)
    COUNTER.add("all-to-all", x, n, axis, direction)
    return torch.cat([r.to(x.device) for r in recv.unbind(0)], dim=concat_dim % x.dim())


class _AllReduceSum(torch.autograd.Function):
    """Forward: the sum over ``axis``.  Backward: the identity (every rank
    backpropagates the same loss, so each partial's gradient is the sum's)."""

    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    """Forward: the tiled gather along ``dim``.  Backward: a reduce-scatter
    (the ranks' gradients of the whole summed, this rank's slice kept)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    """Forward: the tiled exchange.  Backward: the inverse exchange (each
    chunk's gradient sent back to the rank it came from)."""

    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim % x.dim(), concat_dim % x.dim())
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g, axis, concat_dim, split_dim, "backward"), None, None, None


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": the identity forward, the sum over 'model' backward."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "model", "sum", "backward")


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_reduce(x: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
    """Sum (or max) of ``x`` over the ranks of ``axes``; a new tensor.
    Over a tuple of axes, one reduction per axis.  Differentiable for
    ``sum`` (the backward is the identity); ``max`` takes no gradient."""
    if isinstance(axes, tuple):
        for a in axes:
            x = all_reduce(x, a, op)
        return x
    if axis_size(axes) == 1:
        return x
    if op == "max":
        return _all_reduce(x.detach(), axes, "max")
    return _AllReduceSum.apply(x, axes)


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axes`` concatenated along ``dim`` in rank
    order (tiled); over a tuple of axes, row-major (the last axis gathered
    first).  The backward is a reduce-scatter."""
    if isinstance(axes, tuple):
        for a in reversed(axes):
            x = all_gather(x, a, dim)
        return x
    if axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, axes, dim % x.dim())


def all_to_all(x: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``x`` cut into as many chunks along ``split_dim`` as ``axis`` has
    ranks, chunk j sent to rank j, the chunks received concatenated along
    ``concat_dim`` in source order (``jax.lax.all_to_all(..., tiled=True)``).
    The backward is the inverse exchange."""
    if axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-parallel product under tensor parallelism:
    ``x`` itself forward, its gradient summed over 'model' backward (each
    model rank's is only its columns' part).  A no-op without TP."""
    if tp_size() == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x)


def share_grad(x: torch.Tensor, axes) -> torch.Tensor:
    """``x`` itself forward, computed alike on every rank of ``axes``: its
    gradient divided by their number backward, so that a sum of the ranks'
    gradients over ``axes`` counts it once."""
    n = axis_size(axes)
    if n == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ShareGrad.apply(x, n)
