"""Model construction: config -> model instance — the port of
``src/repro/models/registry.py``.  Decoder-only configs only; the
encoder-decoder ``EncDecLM`` (whisper) is a later slice (ROADMAP.md)."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DecoderLM

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda") -> DecoderLM:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: EncDecLM is not ported yet (ROADMAP.md, queue 1 item 8)")
    return DecoderLM(cfg, device=device)
