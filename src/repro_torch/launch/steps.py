"""Serving step functions — the port of ``make_prefill_step`` and
``make_serve_step`` in ``src/repro/launch/steps.py``.

Each step runs on the model's device (``build_model`` defaults to the
card and raises without one) and picks the next token greedily over the
real vocabulary, as the reference does.  The prefill step hands the whole
batch to the model, so a VLM's ``vision_embeds`` and whisper's ``frames``
go through with the tokens; the serve step takes the model's own state
(``DecodeState``, or ``EncDecState`` for whisper).  The train step, ``input_specs``
and ``SHAPES`` wait for the training and dry-run slices of the port.
"""
from __future__ import annotations

import torch

__all__ = ["make_prefill_step", "make_serve_step"]


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
