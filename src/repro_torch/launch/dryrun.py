"""Dry-run of every (architecture × input shape) cell on the production
meshes — the port of ``src/repro/launch/dryrun.py``, with its CLI, cells,
file names and JSON keys:

    16×16        ("data", "model")          — 256 ranks
    2×16×16      ("pod", "data", "model")   — 512 ranks

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b \\
        --shape train_4k --mesh pod --depth full --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh pod,multipod --depth full

Nothing is compiled and nothing is allocated.  A cell runs rank 0's step
— ``make_train_step(mesh=)`` (AdamW state placed by
``opt_state_sharding``, ``--microbatches`` at full depth, as the
reference), ``make_prefill_step`` or ``make_serve_step(mesh=)`` — on
meta tensors (shapes and dtypes only), under a count-only view of the
production mesh (``Mesh.view(..., count_only=True)``): every collective
of ``models.sharding`` returns a result of its shape and is recorded in
``COUNTER`` as the real one would be, without process groups.  The
kernels' wrappers return outputs of their shapes and add their kernel's
operations and bytes (the bound formulas of their ``work`` functions) to
``kernels.build.META_WORK``; their plain versions do not run.  An eager
trace sees every layer, so full depth is exact; depths 1 and 2 (that
many scan units) stay for the reference's schema, and full =
f(1) + (units - 1)·(f(2) - f(1)) holds on a uniform stack.

What a cell records (per rank, rank 0; every rank's view counts alike):
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
    step (the products and attentions PyTorch runs: the matmuls, the
    plain backwards) plus the kernels' operations;
  * ``bytes_accessed``: every dispatched op's input and output bytes,
    views and allocations without a write excluded, plus the kernels'
    bytes — the convention of XLA's "bytes accessed" (operands read,
    results written, per op, with no cache model);
  * ``memory``: ``argument_bytes`` and ``output_bytes`` the rank's local
    shards of the step's arguments (params, optimizer state, its batch
    rows or decode state) and results; ``temp_bytes`` the peak of live
    bytes in tensors the step made (each allocation tracked until it is
    freed); ``generated_code_bytes`` 0 (no compiled program);
  * ``collectives``: ``launch.hlo_analysis.collective_stats`` of the
    step's records (both directions of a train step);
  * ``lower_s`` the trace's seconds; ``compile_s`` null.
A cell that fails in ``sweep`` writes ``.FAILED.json``.  These are counts
of the port's step on meta tensors, not measurements of a device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.kernels import build as kbuild
from repro_torch.launch.hlo_analysis import collective_stats
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import (
    decode_state_sharding, param_sharding, shard_tensor, spec_axes, tree_map_with_path)
from repro_torch.launch.steps import (
    SHAPES, init_train_state_specs, input_specs, make_prefill_step, make_serve_step,
    make_train_step, skip_reason)
from repro_torch.models import sharding
from repro_torch.models.registry import build_model
from repro_torch.models.sharding import MeshLayout
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["PRODUCTION_MESHES", "StepCount", "argument_bytes", "count", "count_step",
           "local_state", "main", "run_cell", "step_fn", "sweep"]

PRODUCTION_MESHES = {"pod": {"data": 16, "model": 16},
                     "multipod": {"pod": 2, "data": 16, "model": 16}}
# allocations that write nothing: no bytes accessed
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class _Traffic(TorchDispatchMode):
    """Each dispatched op's input and output bytes (a view's none, an
    allocation that writes nothing none), and the live bytes of the
    tensors made under it (each new storage counted until its tensor is
    freed) with their peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        views = [r.alias_info is not None and not r.alias_info.is_write for r in returns]
        outs = _tensors(out)
        if returns and all(views):
            return out
        if func._schema.name.split("::")[-1] not in _NO_WRITE:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
                + sum(_nbytes(t) for t in outs)
        for r, t in zip(returns, outs):
            if r.alias_info is None:   # new storage
                n = _nbytes(t)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


@dataclasses.dataclass
class StepCount:
    """What one step on meta tensors under a count-only mesh did."""

    flops: int
    bytes_accessed: int
    temp_bytes: int
    records: list            # models.sharding.CollectiveRecord, in order
    kernel_calls: dict       # kernel name -> calls on meta tensors
    trace_s: float
    outputs: object = None
    argument_bytes: int | None = None   # the rank's step arguments (``count``)

    def summary(self, direction: str | None = None) -> dict:
        out: dict = {}
        for r in self.records:
            if direction is None or r.direction == direction:
                s = out.setdefault(r.kind, {"count": 0, "bytes": 0})
                s["count"] += 1
                s["bytes"] += r.nbytes
        return out


def count_step(fn, *args) -> StepCount:
    """``fn(*args)`` (a step on meta tensors, its mesh context count-only)
    with its operations, bytes, temporaries and collectives counted."""
    sharding.COUNTER.reset()
    kbuild.reset_meta()
    traffic = _Traffic()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, traffic:
        out = fn(*args)
    trace_s = time.perf_counter() - t0
    return StepCount(
        flops=int(fc.get_total_flops()) + int(kbuild.META_WORK["flops"]),
        bytes_accessed=traffic.bytes + int(kbuild.META_WORK["bytes"]),
        temp_bytes=traffic.peak, records=list(sharding.COUNTER.records),
        kernel_calls=dict(kbuild.META_WORK["calls"]), trace_s=trace_s, outputs=out)


def _shard_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_tensor(tree, specs, mesh)


def _cast(tree, dtype):
    if dtype is None:
        return tree
    return tree_map_with_path(lambda _, t: t.to(dtype) if t.is_floating_point() else t, tree)


def local_state(model, batch: int, context_len: int, mesh, dtype=torch.bfloat16):
    """Rank ``mesh``'s shard of a decode state holding ``context_len``
    tokens a sequence, as meta tensors, placed by
    ``decode_state_sharding``, with its ``layout``."""
    full = model.decode_state_shape(batch, context_len, dtype=dtype)
    specs = decode_state_sharding(full, mesh)
    local = dataclasses.replace(full, **{k: shard_tensor(getattr(full, k), sp, mesh)
                                         for k, sp in specs.items()})
    batch_axes = spec_axes(specs["context_lens"][0]) if specs["context_lens"] else ()
    pages = specs.get("k_pages")
    local.layout = MeshLayout(batch_axes, bool(pages and pages[2] == "model"))
    return local


def step_fn(model, kind: str, mesh, *, batch: int, seq: int, dtype=None,
            num_microbatches: int = 1, remat: bool = True):
    """(fn, args, argument tensors) of rank ``mesh``'s ``kind`` step on meta
    tensors: "train" (``make_train_step``, params and AdamW state on their
    train shards, the whole batch of ``batch`` x ``seq`` in), "prefill"
    (``make_prefill_step``), or "decode" (``make_serve_step`` over a state
    of ``seq`` tokens).  ``dtype``: the weights cast
    (None: the init's)."""
    cfg = model.cfg
    fold = cfg.fold_model_axis_into_dp
    shape = dataclasses.replace(SHAPES["train_4k" if kind == "train" else
                                       "prefill_32k" if kind == "prefill" else "decode_32k"],
                                seq_len=seq, global_batch=batch)
    if kind == "train":
        opt_cfg = AdamWConfig(fp32_master=cfg.fp32_master)
        full, opt_full = init_train_state_specs(model, opt_cfg)
        full = _cast(full, dtype)
        if dtype is not None:
            from repro_torch.optim.adamw import adamw_init

            opt_full = adamw_init(full, opt_cfg)
        specs = param_sharding(full, mesh, mode="train", fold_model=fold)
        params = _shard_tree(full, specs, mesh)
        opt = {"step": opt_full["step"],
               **{k: _shard_tree(opt_full[k], specs, mesh) for k in opt_full if k != "step"}}
        data = input_specs(cfg, shape, model)
        step = make_train_step(model, opt_cfg, remat=remat, num_microbatches=num_microbatches,
                               mesh=mesh)
        return step, (params, opt, data)
    full = _cast(model.param_shapes(), dtype)
    params = _shard_tree(full, param_sharding(full, mesh, mode="serve", fold_model=fold), mesh)
    if kind == "prefill":
        return make_prefill_step(model, mesh=mesh), (params, input_specs(cfg, shape, model))
    state = local_state(model, batch, seq, mesh,
                        dtype=torch.bfloat16 if dtype is None else dtype)
    tokens = torch.empty((batch,), dtype=torch.int32, device="meta")
    return make_serve_step(model, mesh=mesh), (params, state, tokens)


def count(cfg, kind: str, mesh_shape: dict[str, int], rank: int = 0, **kw) -> StepCount:
    """``step_fn``'s step of ``cfg`` on rank ``rank`` of a count-only mesh
    of ``mesh_shape``, counted (``count_step``), with its
    ``argument_bytes``."""
    model = build_model(cfg, device="meta")
    mesh = Mesh.view(mesh_shape, rank, device="meta", count_only=True)
    fold = cfg.fold_model_axis_into_dp
    with sharding.mesh_context(mesh, fold_model_axis=fold):
        fn, args = step_fn(model, kind, mesh, **kw)
        got = count_step(fn, *args)
        got.argument_bytes = argument_bytes(kind, args, mesh, fold)
    return got


def argument_bytes(kind: str, args, mesh, fold: bool) -> int:
    """The bytes of the rank's arguments of ``step_fn``'s ``kind`` step:
    params and AdamW state (train), or params, and the rank's rows of the
    batch (train, prefill), or the decode state and tokens (decode)."""
    from repro_torch.data.sharded import rank_rows

    if kind == "decode":
        return sum(_nbytes(t) for t in _tensors(args))
    *state, data = args
    rows = rank_rows(data, mesh, fold_model=fold)[0]
    return sum(_nbytes(t) for t in _tensors(state)) + sum(_nbytes(t) for t in _tensors(rows))


def _cfg_at_depth(cfg, depth: str):
    """full → as assigned; 1|2 → that many scan units."""
    if depth == "full":
        return cfg
    units = int(depth)
    group = cfg.moe_every if (cfg.family == "moe" and cfg.moe_every > 1) else 1
    kw = {"num_layers": units * group}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = units
    return dataclasses.replace(cfg, **kw)


def _units(cfg) -> int:
    group = cfg.moe_every if (cfg.family == "moe" and cfg.moe_every > 1) else 1
    return cfg.num_layers // group


def _write(out_dir, name, result) -> None:
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / name).write_text(json.dumps(result, indent=2))


def run_cell(arch: str, shape_name: str, mesh_kind: str, depth: str, out_dir: str, *,
             remat: bool = True, num_microbatches: int = 4) -> dict:
    full_cfg = get_config(arch)
    shape = SHAPES[shape_name]
    reason = skip_reason(full_cfg, shape)
    fname = f"{arch}__{shape_name}__{mesh_kind}__d{depth}.json"
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "depth": depth,
        "units_total": _units(full_cfg),
        "model_params": full_cfg.param_count(),
        "model_params_active": full_cfg.active_param_count(),
    }
    if reason:
        result["skipped"] = reason
        _write(out_dir, fname, result)
        print(f"[dryrun] {arch} × {shape_name} × {mesh_kind}: SKIPPED ({reason})")
        return result

    cfg = _cfg_at_depth(full_cfg, depth)
    fold = cfg.fold_model_axis_into_dp
    model = build_model(cfg, device="meta")
    mesh = Mesh.view(PRODUCTION_MESHES[mesh_kind], 0, device="meta", count_only=True)
    # the analysis variants keep microbatches=1, the full depth accumulates
    n_micro = num_microbatches if (shape.kind == "train" and depth == "full") else 1
    with sharding.mesh_context(mesh, fold_model_axis=fold):
        fn, args = step_fn(model, shape.kind, mesh, batch=shape.global_batch,
                           seq=shape.seq_len, num_microbatches=n_micro, remat=remat)
        arg_bytes = argument_bytes(shape.kind, args, mesh, fold)
        got = count_step(fn, *args)
    out_bytes = sum(_nbytes(t) for t in _tensors(got.outputs))
    coll = collective_stats(got.records)
    result.update({
        "lower_s": round(got.trace_s, 2),
        "compile_s": None,
        "flops": float(got.flops),
        "bytes_accessed": float(got.bytes_accessed),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": got.temp_bytes,
            "generated_code_bytes": 0,
        },
        "collectives": {
            "bytes_by_kind": coll.by_kind_bytes,
            "count_by_kind": coll.by_kind_count,
            "wire_bytes": coll.wire_bytes,
            "wire_bytes_bf16_adjusted": coll.wire_bytes_bf16_adjusted,
        },
        "kernel_calls": got.kernel_calls,
        "n_devices": math.prod(mesh.shape.values()),
    })
    _write(out_dir, fname, result)
    print(f"[dryrun] {arch} × {shape_name} × {mesh_kind} (depth={depth}): "
          f"traced {got.trace_s:.1f}s, flops {result['flops']:.3e}, "
          f"args {arg_bytes / 2**30:.2f} GiB/rank, temp {got.temp_bytes / 2**30:.2f} GiB/rank, "
          f"wire {coll.wire_bytes / 2**20:.1f} MiB", flush=True)
    return result


def sweep(archs, shapes, meshes, depths, out_dir, *, num_microbatches=8) -> list[str]:
    """Every cell in one process; each is fail-isolated and writes its JSON
    as it ends.  Returns the failed cells."""
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                for depth in depths:
                    tag = f"{arch}×{shape}×{mesh_kind}×d{depth}"
                    try:
                        run_cell(arch, shape, mesh_kind, depth, out_dir,
                                 num_microbatches=num_microbatches)
                    except Exception as e:  # noqa: BLE001 — record and continue
                        failures.append(tag)
                        err = f"{type(e).__name__}: {e}"
                        print(f"[dryrun] FAILED {tag}: {err[:500]}", flush=True)
                        _write(out_dir, f"{arch}__{shape}__{mesh_kind}__d{depth}.FAILED.json",
                               {"error": err[:2000], "cell": tag})
    print(f"[dryrun] sweep done; {len(failures)} failures: {failures}")
    return failures


def main(argv: list[str] | None = None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="arch id, or comma list, or 'all'")
    ap.add_argument("--shape", default="all", help="shape name, comma list, or 'all'")
    ap.add_argument("--mesh", default="pod", help="pod | multipod | pod,multipod")
    ap.add_argument("--depth", default="full", help="full | 1 | 2 | comma list")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--microbatches", type=int, default=8)
    args = ap.parse_args(argv)
    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    return sweep(archs, shapes, args.mesh.split(","), args.depth.split(","), args.out,
                 num_microbatches=args.microbatches)


if __name__ == "__main__":
    main()
