"""Step functions and shape specs — the port of
``src/repro/launch/steps.py``.

Each step runs on the model's device (``build_model`` defaults to the
card and raises without one).  ``make_train_step`` takes the loss's
gradients with autograd (``make_grad_step``) and applies
``optim.adamw_update``, with ``num_microbatches`` accumulated in f32 as
the reference does.  The
prefill and serve steps pick the next token greedily over the real
vocabulary; the prefill step hands the whole batch to the model, so a
VLM's ``vision_embeds`` and whisper's ``frames`` go through with the
tokens; the serve step takes the model's own state (``DecodeState``, or
``EncDecState`` for whisper).  ``input_specs`` gives meta tensors where
the reference gives ``ShapeDtypeStruct``s: shapes and dtypes, no
storage.

Under a device mesh (``make_prefill_step(model, mesh=...)``, params from
``launch.shardings.shard_params``) the prefill and serve steps take and
return the WHOLE batch of tokens, as the reference's jitted steps do with
their shardings: each rank computes its rows (``batch_spec``'s split for
the prefill, the decode state's for a serve step), picks greedily over
vocab-sharded logits, and the ranks' tokens are gathered.  The state is
this rank's shard.  So does the train step: the whole global batch in,
each rank's rows through the model on its train shards (FSDP over 'data',
TP over 'model': the reference's ``mode="train"`` placements), the DP
gradient sums after the backward, AdamW on the shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.data.sharded import rank_rows
from repro_torch.launch.shardings import (
    batch_spec, grad_reduce_axes, param_sharding, spec_axes, spec_leaves, split_axes)
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import leaves, unflatten

__all__ = [
    "SHAPES", "ShapeSpec", "input_specs", "init_train_state_specs", "make_grad_step",
    "make_train_step",
    "make_prefill_step",
    "make_serve_step", "greedy_generate", "cell_is_runnable", "skip_reason",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def skip_reason(cfg: ModelConfig, shape: ShapeSpec) -> str | None:
    """None if the cell runs; else why it is skipped (recorded per-cell)."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return "full quadratic attention: 500K decode needs sub-quadratic arch"
    return None


def cell_is_runnable(arch: str, shape_name: str) -> bool:
    return skip_reason(get_config(arch), SHAPES[shape_name]) is None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, model=None) -> dict[str, Any]:
    """The step's inputs as meta tensors (never allocates)."""
    b = shape.global_batch
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _meta((b, shape.seq_len), torch.int32)}
        if cfg.family == "vlm":
            specs["vision_embeds"] = _meta((b, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        if cfg.is_encoder_decoder:
            specs["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
        return specs
    if shape.kind == "decode":
        if model is None:
            from repro_torch.models.registry import build_model

            model = build_model(cfg, device="cpu")  # no storage: the shapes only
        return {"tokens": _meta((b,), torch.int32),
                "state": model.decode_state_shape(b, shape.seq_len)}
    raise ValueError(shape.kind)


def init_train_state_specs(model, opt_cfg: AdamWConfig):
    """(params, AdamW state) as meta tensors: the full shapes and dtypes of
    a train state, nothing allocated (the reference's ``eval_shape``s)."""
    from repro_torch.optim.adamw import adamw_init

    params = model.param_shapes()
    return params, adamw_init(params, opt_cfg)


def _loss_grads(model, params, batch, remat, batch_axes=()):
    """(loss, metrics, grads): the loss's gradients w.r.t. every leaf of
    ``params``, in the params' structure and dtypes."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = model.train_loss(params, batch, remat=remat, batch_axes=batch_axes)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(params, grads)


def _reduce_grads(grads, axes_of):
    """``grads`` with each leaf summed over its DP axes (``axes_of``, JAX's
    leaf order), in f32, cast back: the leaves that share a set of axes and
    a dtype go in one flat all-reduce an axis."""
    flat = leaves(grads)
    groups: dict = {}
    for i, (g, axes) in enumerate(zip(flat, axes_of)):
        if axes:
            groups.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in groups.items():
        buf = sharding.all_reduce(torch.cat([flat[i].float().reshape(-1) for i in idx]), axes)
        for i, part in zip(idx, buf.split([flat[i].numel() for i in idx])):
            flat[i] = part.reshape(flat[i].shape).to(flat[i].dtype)
    return unflatten(grads, flat)


def _train_specs(model, mesh) -> list:
    """The train placements of ``model``'s param leaves on ``mesh``, in
    JAX's leaf order."""
    return spec_leaves(param_sharding(model.param_shapes(), mesh, mode="train",
                                      fold_model=model.cfg.fold_model_axis_into_dp))


def make_grad_step(model, *, remat: bool = True, num_microbatches: int = 1, mesh=None):
    """(params, batch) -> (loss, metrics, grads), the gradients of the
    global batch's mean loss, in the params' structure.  num_microbatches
    > 1: the batch's leading axis is split, each microbatch's gradients
    summed in f32 and averaged.

    Under a mesh: ``params`` are this rank's train shards
    (``shard_params(..., mode="train")``), ``batch`` the WHOLE global
    batch, of which the rank takes its rows (``data.sharded.rank_rows``;
    with microbatches, the global batch is split first, as the
    reference's is, and the rank takes its rows of each microbatch, which
    may be split over fewer DP axes than the whole batch); the grads are
    this rank's shards
    of the global gradients: after the backward, each leaf's gradient is
    summed over the DP axes its train placement replicates it on
    (``launch.shardings.grad_reduce_axes``)."""
    reduce_axes = []   # each leaf's DP sum axes, placed at the first call

    def grad_step(params, batch):
        def local(b):
            if mesh is None:
                return b, ()
            return rank_rows(b, mesh, fold_model=sharding.tp_folded())

        with _in_mesh(mesh, model):
            if num_microbatches == 1:
                mine, axes = local(batch)
                loss, metrics, grads = _loss_grads(model, params, mine, remat, axes)
            else:
                def split(x):
                    x = torch.as_tensor(x)
                    mb = x.shape[0] // num_microbatches
                    return x.reshape((num_microbatches, mb) + tuple(x.shape[1:]))

                batch_mb = {k: split(v) for k, v in batch.items()}
                acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                       for p in leaves(params)]
                loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
                for i in range(num_microbatches):
                    mb, axes = local({k: v[i] for k, v in batch_mb.items()})
                    loss, _, grads = _loss_grads(model, params, mb, remat, axes)
                    for a, g in zip(acc, leaves(grads)):
                        a += g.float()
                    loss_sum = loss_sum + loss
                    del grads
                grads = unflatten(params, [a / num_microbatches for a in acc])
                loss = loss_sum / num_microbatches
                metrics = {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                           device=model.device)}
            if mesh is not None:
                if not reduce_axes:
                    reduce_axes.extend(grad_reduce_axes(sp, mesh, fold_model=sharding.tp_folded())
                                       for sp in _train_specs(model, mesh))
                with sharding.recording("backward"):
                    grads = _reduce_grads(grads, reduce_axes)
        return loss, metrics, grads

    return grad_step


def make_train_step(model, opt_cfg: AdamWConfig, *, remat: bool = True,
                    num_microbatches: int = 1, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and state updated in place.  num_microbatches > 1 = gradient
    accumulation: the batch's leading axis is split, each microbatch's
    gradients are summed in f32 and averaged, one optimizer step per
    global batch.  Under a mesh (``make_grad_step``): this rank's shards
    of the params and of the optimizer state
    (``launch.shardings.opt_state_sharding``), the whole global batch in;
    the clip's norm is the global gradient's."""
    grad_step = make_grad_step(model, remat=remat, num_microbatches=num_microbatches, mesh=mesh)
    split = []   # each leaf's split axes under a mesh, placed at the first call

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_step(params, batch)
        if mesh is not None and not split:
            split.extend(split_axes(sp) for sp in _train_specs(model, mesh))
        with _in_mesh(mesh, model), sharding.recording("backward"):
            params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                                 split=split or None)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def _greedy(model, logits) -> torch.Tensor:
    """The first index of the highest logit among the real vocabulary.
    Over vocab-sharded logits (this rank's columns under a mesh): each
    rank's max and first argmax, then an all_gather of the (value, global
    index) pairs over 'model' and the first of the highest, so that ties
    go to the lowest index as ``torch.argmax`` breaks them on the row."""
    vocab, n = model.cfg.vocab_size, logits.shape[-1]
    if n == model.cfg.padded_vocab:
        return torch.argmax(logits[:, :vocab].float(), dim=-1).to(torch.int32)
    lo = sharding.axis_index("model") * n
    cols = torch.arange(lo, lo + n, device=logits.device)
    x = logits.float().masked_fill(cols >= vocab, float("-inf"))
    idx = torch.argmax(x, dim=-1, keepdim=True)
    vals = sharding.all_gather(torch.gather(x, 1, idx), "model", 1)
    idxs = sharding.all_gather(idx + lo, "model", 1)
    return torch.gather(idxs, 1, torch.argmax(vals, dim=1, keepdim=True))[:, 0].to(torch.int32)


def _in_mesh(mesh, model):
    """The mesh context of a step's call (none without a mesh: the
    caller's own, if any)."""
    if mesh is None:
        return contextlib.nullcontext()
    return sharding.mesh_context(mesh, fold_model_axis=model.cfg.fold_model_axis_into_dp)


def make_prefill_step(model, *, mesh=None):
    """(params, batch) -> (first token [b] int32, the model's decode state)."""
    def prefill_step(params, batch):
        with _in_mesh(mesh, model):
            if sharding.get_mesh() is None:
                logits, state = model.prefill(params, batch)
                return _greedy(model, logits), state
            b = len(batch["tokens"])
            spec = batch_spec(sharding.get_mesh(), b, fold_model=sharding.tp_folded())
            axes = spec_axes(spec[0]) if spec else ()
            mine = {k: sharding.take_shard(torch.as_tensor(v), axes, 0)
                    for k, v in batch.items()}
            logits, state = model.prefill(params, mine, batch_axes=axes)
            return sharding.all_gather(_greedy(model, logits), axes, 0), state

    return prefill_step


def make_serve_step(model, *, mesh=None):
    """One decode iteration: (params, state, tokens [b]) -> (next token
    [b] int32 by greedy choice, updated decode state)."""
    def serve_step(params, state, tokens):
        with _in_mesh(mesh, model):
            layout = getattr(state, "layout", None)
            axes = layout.batch_axes if layout is not None else ()
            tokens = sharding.take_shard(torch.as_tensor(tokens), axes, 0)
            logits, state = model.decode_step(params, state, tokens)
            return sharding.all_gather(_greedy(model, logits), axes, 0), state

    return serve_step


def greedy_generate(model, params, tokens, max_new: int) -> list[int]:
    """Monolithic greedy generation of one prompt (``tokens`` [s]): the
    prefill step's token, then ``max_new`` serve steps at b = 1 -- what a
    served request must return with the same weights."""
    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)
    tok, state = prefill_step(params, {"tokens": torch.as_tensor(tokens)[None]})
    out = [int(tok[0])]
    for _ in range(max_new):
        tok, state = serve_step(params, state, tok)
        out.append(int(tok[0]))
    return out
