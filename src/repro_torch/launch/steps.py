"""Step functions and shape specs — the port of
``src/repro/launch/steps.py``.

Each step runs on the model's device (``build_model`` defaults to the
card and raises without one).  ``make_train_step`` takes the loss's
gradients with autograd and applies ``optim.adamw_update``, with
``num_microbatches`` accumulated in f32 as the reference does.  The
prefill and serve steps pick the next token greedily over the real
vocabulary; the prefill step hands the whole batch to the model, so a
VLM's ``vision_embeds`` and whisper's ``frames`` go through with the
tokens; the serve step takes the model's own state (``DecodeState``, or
``EncDecState`` for whisper).  ``input_specs`` gives meta tensors where
the reference gives ``ShapeDtypeStruct``s: shapes and dtypes, no
storage.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import leaves, unflatten

__all__ = [
    "SHAPES", "ShapeSpec", "input_specs", "make_train_step", "make_prefill_step",
    "make_serve_step", "cell_is_runnable", "skip_reason",
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


def _loss_grads(model, params, batch, remat):
    """(loss, metrics, grads): the loss's gradients w.r.t. every leaf of
    ``params``, in the params' structure and dtypes."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss, metrics = model.train_loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(params, grads)


def make_train_step(model, opt_cfg: AdamWConfig, *, remat: bool = True,
                    num_microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    params and state updated in place.  num_microbatches > 1 = gradient
    accumulation: the batch's leading axis is split, each microbatch's
    gradients are summed in f32 and averaged, one optimizer step per
    global batch."""

    def train_step(params, opt_state, batch):
        if num_microbatches == 1:
            loss, metrics, grads = _loss_grads(model, params, batch, remat)
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
                loss, _, grads = _loss_grads(model, params,
                                             {k: v[i] for k, v in batch_mb.items()}, remat)
                for a, g in zip(acc, leaves(grads)):
                    a += g.float()
                loss_sum = loss_sum + loss
                del grads
            grads = unflatten(params, [a / num_microbatches for a in acc])
            loss = loss_sum / num_microbatches
            metrics = {"nll": loss, "aux": torch.zeros((), dtype=torch.float32,
                                                       device=model.device)}
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def _greedy(model, logits) -> torch.Tensor:
    return torch.argmax(logits[:, : model.cfg.vocab_size].float(), dim=-1).to(torch.int32)


def make_prefill_step(model):
    """(params, batch) -> (first token [b] int32, the model's decode state)."""
    def prefill_step(params, batch):
        logits, state = model.prefill(params, batch)
        return _greedy(model, logits), state

    return prefill_step


def make_serve_step(model):
    """One decode iteration: (params, state, tokens [b]) -> (next token
    [b] int32 by greedy choice, updated decode state)."""
    def serve_step(params, state, tokens):
        logits, state = model.decode_step(params, state, tokens)
        return _greedy(model, logits), state

    return serve_step
