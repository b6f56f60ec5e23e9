"""Model construction: config -> model instance (``DecoderLM`` or
``EncDecLM``) — the port of ``src/repro/models/registry.py``.  Models run
on the card unless the caller passes ``device="cpu"``."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DecoderLM
from repro_torch.models.whisper import EncDecLM

__all__ = ["build_model"]


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda"):
    if cfg.is_encoder_decoder:
        return EncDecLM(cfg, device=device)
    return DecoderLM(cfg, device=device)
