"""Architecture registry — ``--arch <id>`` resolution.

Every assigned architecture (plus the paper's own evaluation model) is a
module here exposing ``CONFIG`` (exact public dims) and ``SMOKE``
(reduced same-family config for CPU tests).

Copy of ``src/repro/configs/__init__.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id (CLI spelling) -> module name
ARCHS: dict[str, str] = {
    "granite-34b": "granite_34b",
    "deepseek-67b": "deepseek_67b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-9b": "yi_9b",
    "whisper-large-v3": "whisper_large_v3",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "mamba2-780m": "mamba2_780m",
    "hymba-1.5b": "hymba_1p5b",
    # the paper's own model (not an assigned cell; used by benchmarks)
    "mistral-large-123b": "mistral_large_123b",
}

ASSIGNED = [a for a in ARCHS if a != "mistral-large-123b"]


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def list_archs() -> list[str]:
    return list(ARCHS)
