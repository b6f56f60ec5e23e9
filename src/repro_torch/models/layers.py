"""Shared NN building blocks — plain functions on tensors, the port of
``src/repro/models/layers.py``.  Params are nested dicts of tensors with
the reference's layout: dense ``{"w": [in, out], "b"?}``, norms
``{"scale"}``, embeddings ``{"table": [vocab, d]}``; bf16 storage, f32
where numerics demand."""
from __future__ import annotations

import itertools

import torch

PARAM_DTYPE = torch.bfloat16

__all__ = ["PARAM_DTYPE", "normal_", "dense_init", "dense", "rmsnorm", "layernorm", "swiglu",
           "gelu_mlp", "embed"]


def normal_(out: torch.Tensor, gen: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``out`` (any dtype) with N(0, 1) * scale drawn in f32 from
    ``gen`` — the reference's ``normal(f32) * scale -> PARAM_DTYPE``."""
    draw = torch.randn(out.shape, generator=gen, device=out.device, dtype=torch.float32)
    out.copy_(draw.mul_(scale))
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, lead: tuple = (),
               bias: bool = False, scale: float | None = None, device=None) -> dict:
    """``{"w": [*lead, d_in, d_out]}`` (+ a zero ``"b"``) in PARAM_DTYPE,
    N(0, 1) * scale (default d_in^-0.5), drawn one [d_in, d_out] matrix at
    a time so that the f32 draw stays one matrix large."""
    scale = d_in ** -0.5 if scale is None else scale
    w = torch.empty((*lead, d_in, d_out), dtype=PARAM_DTYPE, device=device)
    for idx in itertools.product(*map(range, lead)):
        normal_(w[idx], gen, scale)
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=PARAM_DTYPE, device=device)
    return p


def dense(p, x):
    """``x @ w (+ b)``; bf16 activations meeting f32 weights are promoted
    to f32 first, as the reference's matmul promotes them."""
    if x.dtype != p["w"].dtype:
        x = x.to(torch.promote_types(x.dtype, p["w"].dtype))
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p, x, eps: float = 1e-5):
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"].float()).to(x.dtype)


def layernorm(p, x, eps: float = 1e-5):
    """Statistics in f32, then scale and bias, then a cast back."""
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * p["scale"].float() + p["bias"].float()).to(x.dtype)


def swiglu(p, x):
    h = torch.nn.functional.silu(dense(p["gate"], x)) * dense(p["up"], x)
    return dense(p["down"], h)


def gelu_mlp(p, x):
    """``down(gelu(up(x)))`` with the tanh form of GELU, which is
    ``jax.nn.gelu``'s default (the erf form differs by up to about 1e-3)."""
    return dense(p["down"], torch.nn.functional.gelu(dense(p["up"], x), approximate="tanh"))


def embed(p, tokens):
    return p["table"][tokens]
