"""Shared NN building blocks — plain functions on tensors, the port of
``src/repro/models/layers.py``.  Params are nested dicts of tensors with
the reference's layout: dense ``{"w": [in, out], "b"?}``, norms
``{"scale"}``, embeddings ``{"table": [vocab, d]}``; bf16 storage, f32
where numerics demand.

Under a mesh (``models.sharding``) the params are this rank's shards
(``launch.shardings.shard_params``): a column-parallel ``dense`` gives the
rank's columns as it is; ``row_dense`` contracts the rank's rows of the in
dim and sums the partial products over 'model' (in f32, cast back once);
``swiglu`` runs on the local d_ff; ``embed`` looks up a vocab-sharded
table (a masked local lookup, then a sum over 'model').  Whether a weight
is sharded is read off its local shape against the full dim the caller
names.  Without a mesh every one is the single-device function.

For training under a mesh (the convention of ``models.sharding``): the
input of a column-parallel product goes through ``copy_to_model`` (its
gradient summed over 'model'), ``row_dense``'s slice of a replicated
input takes autograd's own backward (the gradient lands in this rank's
columns, the other ranks' columns summed in by that copy upstream), and
the embedding's sum over 'model' passes its gradient through whole."""
from __future__ import annotations

import itertools

import torch

from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.silu_mul.ops import silu_mul
from repro_torch.models import sharding

PARAM_DTYPE = torch.bfloat16

__all__ = ["PARAM_DTYPE", "normal_", "dense_init", "dense", "row_dense", "rmsnorm",
           "add_rmsnorm", "layernorm", "column_input", "swiglu", "gelu_mlp", "embed"]


def normal_(out: torch.Tensor, gen: torch.Generator, scale: float) -> torch.Tensor:
    """Fill ``out`` (any dtype) with N(0, 1) * scale drawn in f32 from
    ``gen`` — the reference's ``normal(f32) * scale -> PARAM_DTYPE``.  A
    meta tensor is returned as it is (no draw: shapes only)."""
    if out.is_meta:
        return out
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


def row_dense(p, x, d_in: int):
    """Row-parallel ``x @ w (+ b)`` over the full in dim ``d_in``: when w
    holds only this rank's rows (its in dim shorter than ``d_in``), x's
    matching columns (x itself when it is already local) contract them
    and the partial products are summed over 'model' in f32, cast back
    once, the bias added after the sum."""
    w = p["w"]
    if w.shape[-2] == d_in:
        return dense(p, x)
    if x.shape[-1] == d_in:
        x = sharding.take_shard(x, "model", -1)
    y = dense({"w": w}, x)
    y = sharding.all_reduce(y.float(), "model").to(y.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p, x, eps: float = 1e-5):
    """Statistics in f32, times the scale in f32, one cast back to x's
    dtype (``kernels/rmsnorm``: one launch on the card without autograd)."""
    return rmsnorm_ops.rmsnorm(x, p["scale"], eps)


def add_rmsnorm(p, x, residual, eps: float = 1e-5):
    """(x + residual, ``rmsnorm`` of it), in one launch on the card."""
    return rmsnorm_ops.add_rmsnorm(x, residual, p["scale"], eps)


def layernorm(p, x, eps: float = 1e-5):
    """Statistics in f32, then scale and bias, then a cast back."""
    h = x.float()
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean(torch.square(h - mu), dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * p["scale"].float() + p["bias"].float()).to(x.dtype)


def column_input(x, w, d_out: int):
    """``x`` as the input of a product with the column-parallel weight
    ``w`` of full out dim ``d_out``: through ``copy_to_model`` when ``w``
    holds only this rank's columns (else the product runs whole on every
    rank and its input's gradient is whole already).  An input of another
    dtype than ``w`` is promoted first, as ``dense`` promotes it, so that
    the ranks' partial gradients are summed in the product's dtype and
    rounded to the input's once, as on one device."""
    if w.shape[-1] == d_out:
        return x
    if x.dtype != w.dtype:
        x = x.to(torch.promote_types(x.dtype, w.dtype))
    return sharding.copy_to_model(x)


def swiglu(p, x, d_ff: int | None = None):
    """``down(silu(gate(x)) * up(x))``; with ``d_ff`` (the full hidden
    width) the hidden may be this rank's columns and ``down`` row-parallel."""
    if d_ff is not None:
        x = column_input(x, p["gate"]["w"], d_ff)
    h = silu_mul(dense(p["gate"], x), dense(p["up"], x))
    return dense(p["down"], h) if d_ff is None else row_dense(p["down"], h, d_ff)


def gelu_mlp(p, x, d_ff: int | None = None):
    """``down(gelu(up(x)))`` with the tanh form of GELU, which is
    ``jax.nn.gelu``'s default (the erf form differs by up to about 1e-3)."""
    if d_ff is not None:
        x = column_input(x, p["up"]["w"], d_ff)
    h = torch.nn.functional.gelu(dense(p["up"], x), approximate="tanh")
    return dense(p["down"], h) if d_ff is None else row_dense(p["down"], h, d_ff)


def embed(p, tokens, vocab: int | None = None):
    """Rows of ``p["table"]`` for ``tokens``; when the table holds only this
    rank's rows of ``vocab`` (vocab-sharded over 'model'), each rank looks
    up the tokens it holds (zeros for the others) and the ranks' rows sum
    over 'model' (exact: one of them is not zero)."""
    table = p["table"]
    if vocab is None or table.shape[0] == vocab:
        return table[tokens]
    n = table.shape[0]
    local = tokens - sharding.axis_index("model") * n
    inside = (local >= 0) & (local < n)
    x = table[local.clamp(0, n - 1)] * inside[..., None].to(table.dtype)
    return sharding.all_reduce(x.float(), "model").to(table.dtype)
