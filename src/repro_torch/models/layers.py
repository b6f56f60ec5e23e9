"""Shared NN building blocks — plain functions on tensors, the port of
``src/repro/models/layers.py``.  Params are nested dicts of tensors with
the reference's layout: dense ``{"w": [in, out], "b"?}``, norms
``{"scale"}``, embeddings ``{"table": [vocab, d]}``; bf16 storage, f32
where numerics demand."""
from __future__ import annotations

import torch

PARAM_DTYPE = torch.bfloat16

__all__ = ["PARAM_DTYPE", "normal_", "dense", "rmsnorm", "swiglu", "embed"]


def normal_(out: torch.Tensor, gen: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``out`` (any dtype) with N(0, 1) * scale drawn in f32 from
    ``gen`` — the reference's ``normal(f32) * scale -> PARAM_DTYPE``."""
    draw = torch.randn(out.shape, generator=gen, device=out.device, dtype=torch.float32)
    out.copy_(draw.mul_(scale))
    return out


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p, x, eps: float = 1e-5):
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"].float()).to(x.dtype)


def swiglu(p, x):
    h = torch.nn.functional.silu(dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)


def embed(p, tokens):
    return p["table"][tokens]
