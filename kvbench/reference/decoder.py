"""Plain float32 decoder-only LM: the Llama architecture as Yi-9B publishes
it (RMSNorm before attention and MLP, rotary positions with the
rotate-half pairing, grouped-query causal attention, SwiGLU MLP, a final
RMSNorm and an untied LM head), and GraniteMoE's routed experts in place of
the MLP (softmax router, top-k, weights renormalised over the chosen k,
SwiGLU experts, no token dropped).  Granite's scalar multipliers and its
tied head are left out, as the program runs it (the configuration file's
``assumed``).

It reads the benchmark's weights by their keys (``kvbench/weights.py``
makes them): stacked per layer, ``[in, out]`` matrices, padded vocabulary
and expert rows that it never uses.  Every product and reduction is
float32 with TF32 off.  ``fp8=True`` is the control: every matrix product
of the layers but the router's takes its weight and its input rounded to
float8 e4m3 with one scale a tensor (the amax over 448), the step below
bfloat16 that a later change might take.
"""
from __future__ import annotations

import torch

__all__ = ["logits"]

_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    w = w.float()
    if fp8:
        x, w = _fp8(x), _fp8(w)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [s, heads, hd] at positions 0..s-1."""
    s, _, hd = x.shape
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, chunk: int) -> torch.Tensor:
    """Causal grouped-query attention: q [s, h, hd], k and v [s, g, hd];
    query head j reads kv group j // (h / g)."""
    s, h, hd = q.shape
    g = k.shape[1]
    qg = q.reshape(s, g, h // g, hd)
    out = torch.empty_like(q)
    for c0 in range(0, s, chunk):
        c1 = min(s, c0 + chunk)
        sc = torch.einsum("qgjd,kgd->gjqk", qg[c0:c1], k[:c1]) * hd ** -0.5
        mask = torch.arange(c1, device=q.device)[None, :] > \
            torch.arange(c0, c1, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        o = torch.einsum("gjqk,kgd->qgjd", torch.softmax(sc, dim=-1), v[:c1])
        out[c0:c1] = o.reshape(c1 - c0, h, hd)
    return out


def _swiglu(x, gate, up, down, fp8):
    return _mm(torch.nn.functional.silu(_mm(x, gate, fp8)) * _mm(x, up, fp8), down, fp8)


def _moe(x, p, layer, m, fp8):
    e, k = m["num_experts"], m["experts_per_token"]
    probs = torch.softmax(x @ p["router"]["w"][layer][:, :e].float(), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for ex in range(e):
        rows, slot = torch.nonzero(top_i == ex, as_tuple=True)
        if rows.numel():
            y = _swiglu(x[rows], p["gate"][layer][ex], p["up"][layer][ex],
                        p["down"][layer][ex], fp8)
            out.index_add_(0, rows, y * top_p[rows, slot][:, None])
    return out


@torch.no_grad()
def logits(weights: dict, m: dict, tokens: torch.Tensor, rows: torch.Tensor, *,
           fp8: bool = False, chunk: int = 1024) -> torch.Tensor:
    """float32 logits [len(rows), vocab_size] at positions ``rows`` of the
    sequence ``tokens`` [s] (int64, on the weights' device)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        eps, hd = m["norm_eps"], m["head_dim"]
        h, g = m["num_heads"], m["num_kv_heads"]
        lay = weights["layers"]
        x = weights["embed"]["table"][tokens].float()
        s = x.shape[0]
        for i in range(m["num_layers"]):
            a = _rms(x, lay["attn_norm"]["scale"][i], eps)
            at = lay["attn"]
            q = _rope(_mm(a, at["q"]["w"][i], fp8).reshape(s, h, hd), m["rope_theta"])
            kk = _rope(_mm(a, at["k"]["w"][i], fp8).reshape(s, g, hd), m["rope_theta"])
            vv = _mm(a, at["v"]["w"][i], fp8).reshape(s, g, hd)
            x = x + _mm(_attention(q, kk, vv, chunk).reshape(s, h * hd), at["o"]["w"][i], fp8)
            a = _rms(x, lay["mlp_norm"]["scale"][i], eps)
            if m["num_experts"]:
                x = x + _moe(a, lay["moe"], i, m, fp8)
            else:
                mlp = lay["mlp"]
                x = x + _swiglu(a, mlp["gate"]["w"][i], mlp["up"]["w"][i],
                                mlp["down"]["w"][i], fp8)
        y = _rms(x[rows], weights["final_norm"]["scale"], eps)
        head = weights.get("lm_head", weights["embed"])["table"][: m["vocab_size"]]
        return y @ head.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
