"""Sharding rules: param / state trees → placements, and the local shards
they give — the port of ``src/repro/launch/shardings.py``.

Strategy (the reference's):
  * 'model' = tensor parallel.  Column-parallel weights (q/k/v, gate/up,
    in_proj, embedding vocab) shard their OUT dim on 'model'; row-parallel
    weights (o, down, out_proj) shard their IN dim — the classic
    Megatron pairing that needs one collective per block, not two.
  * 'data' = FSDP in training: every ≥2-D param additionally shards a
    non-'model' dim over 'data'.  In serving, params replicate over 'data'.
  * MoE expert stacks [E, in, out] shard E over 'data' (EP) and in/out
    over 'model' by the same column/row rule.
  * 'pod' (multi-pod mesh) is pure DP: params NEVER shard over 'pod'.
  * Divisibility is always checked: a dim that doesn't divide stays
    unsharded (e.g. hymba's 25 heads; its head_dim shards instead).

A spec is a tuple with one entry per dim: ``None``, an axis name, or a
tuple of two or more names (sharded over them jointly, row-major), equal
element for element to the reference's ``PartitionSpec`` (which writes a
tuple of one name as the name; ``spec_axes`` reads either form back).
Placements are plain local shards, not DTensors: the kernels take plain
tensors.
``shard_tensor`` gives this rank's slice of a full tensor under a spec,
``shard_params`` every leaf of a param tree under ``logical_spec``.
The rules read only ``mesh.shape`` (axis name → size), so a stub with a
``shape`` dict serves as the reference's tests' stubs do.

For training: ``opt_state_sharding`` places the AdamW state as the
reference's dry-run does (``m``, ``v`` and ``master`` as the params,
``step`` replicated); ``split_axes`` gives the axes a spec splits a leaf
over (the gradient norm sums a leaf's squares over them),
``grad_reduce_axes`` the DP axes a leaf is replicated over (its gradient
is summed over them after the backward), ``fsdp_plan`` the dims the
forward gathers (those the train placement splits and the serving
placement does not).  ``NamedSharding`` pairs a mesh with a spec, the
placement a checkpoint is restored into.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = [
    "param_sharding", "batch_spec", "decode_state_sharding", "logical_spec",
    "shard_tensor", "shard_params", "tree_map_with_path", "spec_axes", "split_axes",
    "grad_reduce_axes", "fsdp_plan", "opt_state_sharding", "NamedSharding", "spec_leaves",
    "train_state_shardings",
]

# leaf names (last path component up the tree) → role
_COLUMN = {"q", "k", "v", "gate", "up", "in_proj"}
_ROW = {"o", "down", "out_proj"}


def tree_map_with_path(fn, tree, path=()):
    """``fn(path_names, leaf)`` over a tree of dicts (the port's params);
    ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(list(path), tree)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entry(axes: tuple[str, ...]):
    return axes[0] if len(axes) == 1 else tuple(axes)


def _fits(dim: int, mesh, axis) -> bool:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in axes:
        if a not in mesh.shape:
            return False
        n *= mesh.shape[a]
    return dim % n == 0 and dim >= n


def _assign(shape, mesh, prefs) -> tuple:
    """prefs: ordered (dim_index, axis_name_or_tuple).  First fit wins per
    axis and per dim; a tuple shards one dim over several mesh axes
    (e.g. batch over ('pod','data'))."""
    spec: list[Any] = [None] * len(shape)
    used: set[str] = set()
    for dim, axis in prefs:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if used & set(axes) or dim >= len(shape) or spec[dim] is not None:
            continue
        if _fits(shape[dim], mesh, axes):
            spec[dim] = _entry(axes)
            used.update(axes)
    return tuple(spec)


def logical_spec(path_names: list[str], shape: tuple[int, ...], mesh, *, mode: str,
                 fold_model: bool = False) -> tuple:
    """Sharding spec for one parameter leaf.

    Per-layer params live under a "layers"/"enc_layers"/"dec_layers"
    stack, so their leaves carry a LEADING layer dim ([L, in, out]) — all
    dim indices below shift by that lead.

    ``fold_model``: DP+EP deployment — no tensor parallelism; weights are
    pure-FSDP over BOTH axes in training and replicated in serving.
    """
    name = path_names[-1] if path_names else ""
    parent = path_names[-2] if len(path_names) >= 2 else ""
    in_moe = "moe" in path_names and "shared" not in path_names
    fsdp = ("data",) if mode == "train" else ()
    lead = 1 if any(n.endswith("layers") for n in path_names) else 0
    replicated = (None,) * len(shape)

    if fold_model:
        # MoE expert stacks keep EP over 'data' + FSDP over 'model'
        if in_moe and name in ("gate", "up"):
            return _assign(shape, mesh, [(lead, "data"), (lead + 2, "model")])
        if in_moe and name == "down":
            return _assign(shape, mesh, [(lead, "data"), (lead + 1, "model")])
        if mode != "train":
            return replicated  # replicated weights (no TP)
        # non-MoE weights: FSDP over 'data' only (the reference's choice)
        if name == "table":
            return _assign(shape, mesh, [(0, "data")])
        if name == "w" and len(shape) == 2 + lead:
            return _assign(shape, mesh, [(lead, "data")])
        return replicated

    # embedding / lm head tables [V, d]: vocab over model
    if name == "table":
        return _assign(shape, mesh, [(0, "model")] + [(1, a) for a in fsdp])
    if name in ("meta", "dec_pos"):
        return _assign(shape, mesh, [(0, a) for a in fsdp])

    # MoE expert stacks [L?, E, in, out]
    if in_moe and name in ("gate", "up"):
        return _assign(shape, mesh, [(lead, "data"), (lead + 2, "model")])
    if in_moe and name == "down":
        return _assign(shape, mesh, [(lead, "data"), (lead + 1, "model")])
    if in_moe and parent == "router":
        return replicated

    # dense weights [L?, in, out]: the actual leaf is {"w": ..., "b": ...}
    if name == "w" and len(shape) == 2 + lead:
        if parent in _ROW:
            prefs = [(lead, "model")] + [(lead + 1, a) for a in fsdp]
        else:  # _COLUMN and anything unclassified defaults to column
            prefs = [(lead + 1, "model")] + [(lead, a) for a in fsdp]
        return _assign(shape, mesh, prefs)
    if name == "b" and len(shape) == 1 + lead:
        if parent in _COLUMN:
            return _assign(shape, mesh, [(lead, "model")])
        return replicated

    # conv kernels, norms, scalars, ssm vectors: replicate
    return replicated


def param_sharding(params, mesh, *, mode: str, fold_model: bool = False):
    """params tree (tensors, meta tensors included) → tree of specs."""
    return tree_map_with_path(
        lambda names, x: logical_spec(names, tuple(x.shape), mesh, mode=mode,
                                      fold_model=fold_model), params)


def batch_spec(mesh, batch: int | None = None, *, fold_model: bool = False) -> tuple:
    """Batch dim over the largest prefix of the DP axes that divides it
    (long_500k has batch 1 → replicated).  With fold_model, 'model'
    joins the DP axes."""
    axes = [a for a in ("pod", "data") if a in mesh.shape]
    if fold_model and "model" in mesh.shape:
        axes.append("model")
    while axes:
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if batch is None or (batch % n == 0 and batch >= n):
            return (_entry(tuple(axes)),)
        axes = axes[:-1]
    return ()


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def decode_state_sharding(state_shape, mesh) -> dict[str, tuple]:
    """A ``DecodeState`` (meta tensors will do) → {field: spec} for every
    tensor field.

    Pages/states shard batch over (pod, data) and heads (or head_dim when
    heads don't divide) over 'model'.
    """
    dp = _dp_axes(mesh)

    def spec(name, shape):
        # batch shards over the DP axes JOINTLY (tuple) with per-axis
        # prefix fallback for small batches
        batch_prefs = lambda d: [(d, dp[:k]) for k in range(len(dp), 0, -1)]
        if name in ("k_pages", "v_pages"):
            # [L, b, per_seq, bs, g, hd] — per_seq over 'model' is the
            # sequence-parallel flash-decoding layout
            # (attention.paged_decode_with_write)
            prefs = batch_prefs(1) + [(2, "model")]
        elif name == "block_tables":
            prefs = batch_prefs(0) + [(1, "model")]
        elif name in ("ring_k", "ring_v", "meta_k", "meta_v", "cross_k", "cross_v"):
            # [L, b, slots, g, hd] — small (window/meta/enc): replicate TP
            prefs = batch_prefs(1)
        elif name == "ssd_state":
            # [L, b, nh, hd, ns]
            prefs = batch_prefs(1) + [(2, "model"), (3, "model")]
        elif name == "conv_state":
            # [L, b, k-1, c]
            prefs = batch_prefs(1) + [(3, "model")]
        elif name in ("ring_pos", "context_lens"):
            prefs = batch_prefs(0)
        else:
            prefs = []
        return _assign(shape, mesh, prefs)

    return {f.name: spec(f.name, tuple(getattr(state_shape, f.name).shape))
            for f in dataclasses.fields(state_shape)
            if isinstance(getattr(state_shape, f.name), torch.Tensor)}


def shard_tensor(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` under ``spec`` (``mesh``
    gives the rank's ``coords``), in storage of its own; ``x`` itself when
    the spec shards nothing."""
    out = x
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = 0, 1
        for a in spec_axes(entry):
            idx = idx * mesh.shape[a] + mesh.coords[a]
            n *= mesh.shape[a]
        size = x.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return x if out is x else out.clone(memory_format=torch.contiguous_format)


def shard_params(params, mesh, *, mode: str = "serve", fold_model: bool = False):
    """Every leaf of ``params`` → this rank's shard under ``logical_spec``."""
    return tree_map_with_path(
        lambda names, x: shard_tensor(
            x, logical_spec(names, tuple(x.shape), mesh, mode=mode, fold_model=fold_model),
            mesh), params)


# --------------------------------------------------------------- training
def spec_leaves(specs) -> list:
    """The specs of a tree of them (dicts of tuples) in JAX's leaf order
    (``repro_torch.tree.leaves`` of the params they place): a spec is a
    tuple, so it is a leaf here, not a container."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [specs]


def split_axes(spec) -> tuple[str, ...]:
    """Every mesh axis ``spec`` splits its leaf over, in dim order."""
    return tuple(a for entry in spec for a in spec_axes(entry))


def grad_reduce_axes(spec, mesh, *, fold_model: bool = False) -> tuple[str, ...]:
    """The DP axes a leaf of ``spec`` is replicated over: the ranks along
    them saw different rows, so its gradient is summed over them after the
    backward.  Axes the spec splits need none: an FSDP leaf's gradient
    comes out of the gather's reduce-scatter summed, an expert's from the
    exchange."""
    dp = _dp_axes(mesh) + (("model",) if fold_model and "model" in mesh.shape else ())
    return tuple(a for a in dp if a not in split_axes(spec) and mesh.shape[a] > 1)


def fsdp_plan(params, mesh, *, fold_model: bool = False):
    """params (full shapes; meta tensors will do) → per leaf, the
    ``(dim, axes)`` pairs its train placement splits and its serving
    placement does not: the gathers that make a train shard the serving
    shard the model code computes with.  A leaf the two placements split
    alike (MoE experts over 'data', TP columns over 'model') has none."""
    def plan(names, x):
        shape = tuple(x.shape)
        train = logical_spec(names, shape, mesh, mode="train", fold_model=fold_model)
        serve = logical_spec(names, shape, mesh, mode="serve", fold_model=fold_model)
        out = []
        for dim, (t, s) in enumerate(zip(train, serve)):
            if t != s:
                if s is not None:
                    raise ValueError(f"{'/'.join(names)}: train spec {train} does not extend "
                                     f"serve spec {serve}")
                out.append((dim, spec_axes(t)))
        return tuple(out)

    return tree_map_with_path(plan, params)


def opt_state_sharding(param_specs, *, fp32_master: bool = True) -> dict:
    """The AdamW state's specs (``optim.adamw`` layout) from the params':
    the moments and the f32 master copy as the params, ``step``
    replicated (``src/repro/launch/dryrun.py:107-111``)."""
    out = {"step": (), "m": param_specs, "v": param_specs}
    if fp32_master:
        out["master"] = param_specs
    return out


def train_state_shardings(params, mesh, *, fold_model: bool = False,
                          fp32_master: bool = True):
    """(params, AdamW state) → the ``NamedSharding`` trees that place them
    for training on ``mesh`` (``params``: full shapes; meta tensors will
    do), the trees a checkpoint is saved from and restored into."""
    def named(specs):
        if isinstance(specs, dict):
            return {k: named(v) for k, v in specs.items()}
        return NamedSharding(mesh, specs)

    p = param_sharding(params, mesh, mode="train", fold_model=fold_model)
    return named(p), named(opt_state_sharding(p, fp32_master=fp32_master))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each rank's slice of a full leaf lives."""

    mesh: Any
    spec: tuple

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return shard_tensor(x, self.spec, self.mesh)

    def whole_shape(self, shape) -> list[int]:
        """The full shape of which ``shape`` is a rank's shard."""
        out = list(shape)
        for dim, entry in enumerate(self.spec):
            for a in spec_axes(entry):
                out[dim] *= self.mesh.shape[a]
        return out

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole of this rank's shard ``x``: gathered over each split
        dim's axes (row-major, as ``shard`` cut it) with the mesh's
        collectives, on the CPU when its backend moves host memory.  Every
        rank of the mesh calls it."""
        from repro_torch.models import sharding

        if getattr(self.mesh, "backend", None) == "gloo":
            x = x.cpu()
        with sharding.mesh_context(self.mesh):
            for dim, entry in enumerate(self.spec):
                if entry is not None:
                    x = sharding.all_gather(x, spec_axes(entry), dim)
        return x
