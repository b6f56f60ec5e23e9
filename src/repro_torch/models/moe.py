"""Mixture-of-Experts FFN with capacity-factor dispatch — the port of
``src/repro/models/moe.py`` (single device).

Tokens are cut into groups; in each group every (token, k) pair takes the
next free place in its expert's buffer of ``capacity`` rows, in the
flattened (token, k) order, and pairs past the capacity are dropped.
Dispatch is a scatter-add into ``[groups, E_pad * capacity, d]`` (each
row receives one token or zeros, so the sum is exact in any order), the
per-expert SwiGLU runs as batched products over the expert dimension,
and the combine is a gather weighted in f32.  The reference computes all
of this outside any Pallas kernel, so plain torch is its counterpart
here.  A token's output depends on the other tokens of its group: which
pairs are dropped follows from capacity and order.

Experts are padded to ``cfg.padded_experts``; padded experts get -inf
router logits and are never chosen.  The ``shard_map`` expert-parallel
branch of the reference (``moe.py:62-129``) waits for the sharding slice.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, swiglu

__all__ = ["Routing", "capacity", "group_size", "moe_route", "moe_apply", "moe_init"]


def capacity(tokens_per_group: int, k: int, e: int, cf: float) -> int:
    return max(1, -(-int(tokens_per_group * k * cf) // e))


def group_size(n: int) -> int:
    """Tokens a group: the first of the reference's candidates that divides
    the ``n`` tokens (one device, so the group count need divide nothing
    else), else all of them in one group."""
    for cand in (512, 256, 128, 64, 32):
        if cand <= n and n % cand == 0:
            return cand
    return n


@dataclasses.dataclass
class Routing:
    probs: torch.Tensor     # [g, gs, e_pad] f32 router probabilities
    top_p: torch.Tensor     # [g, gs, k] f32, renormalised over the k chosen
    top_idx: torch.Tensor   # [g, gs, k] int64 chosen experts
    keep: torch.Tensor      # [g, gs, k] bool: the pair found a place in the buffer
    slot: torch.Tensor      # [g, gs, k] int64 row in [0, e_pad * cap)
    onehot: torch.Tensor    # [g, gs, k, e_pad] int64
    cap: int


def moe_route(p, xg: torch.Tensor, cfg, cap: int) -> Routing:
    """Router of grouped tokens ``xg`` [g, gs, d]: f32 logits with the padded
    experts at -inf, softmax, top-k renormalised, and each pair's place in
    its expert's buffer from a cumsum over the flattened (token, k) order."""
    g, gs, _ = xg.shape
    e_pad, e, k = cfg.padded_experts, cfg.num_experts, cfg.experts_per_token
    logits = xg.float() @ p["router"]["w"].float()                  # [g, gs, e_pad]
    padded = torch.arange(e_pad, device=xg.device) >= e
    probs = torch.softmax(logits.masked_fill(padded, float("-inf")), dim=-1)
    top_p, top_idx = torch.topk(probs, k, dim=-1)                   # [g, gs, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(top_idx, e_pad)                              # [g, gs, k, e_pad]
    pos = torch.cumsum(onehot.reshape(g, gs * k, e_pad), dim=1).reshape(onehot.shape) - 1
    pos = torch.sum(pos * onehot, dim=-1)                           # [g, gs, k]
    keep = pos < cap
    slot = top_idx * cap + torch.where(keep, pos, 0)
    return Routing(probs, top_p, top_idx, keep, slot, onehot, cap)


def _expert_ffn(buf, p, g, e_pad, cap, d):
    """Per-expert SwiGLU over the buffers: [g, E*C, d] -> [g, E*C, d]."""
    xe = buf.reshape(g, e_pad, cap, d).transpose(0, 1).reshape(e_pad, g * cap, d)
    h = F.silu(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    ye = torch.bmm(h, p["down"])
    return ye.reshape(e_pad, g, cap, d).transpose(0, 1).reshape(g, e_pad * cap, d)


def moe_apply(p, x: torch.Tensor, cfg):
    """x: [b, s, d] -> (out [b, s, d], aux load-balance loss, f32 scalar)."""
    b, s, d = x.shape
    e_pad, e, k = cfg.padded_experts, cfg.num_experts, cfg.experts_per_token
    gs = group_size(b * s)
    g = b * s // gs
    xg = x.reshape(g, gs, d)
    r = moe_route(p, xg, cfg, capacity(gs, k, e, cfg.capacity_factor))

    # dispatch: every kept pair into its own buffer row
    contrib = torch.where(r.keep[..., None], xg[:, :, None, :], 0).to(x.dtype)
    rows = r.slot + (torch.arange(g, device=x.device) * (e_pad * r.cap))[:, None, None]
    buf = torch.zeros((g * e_pad * r.cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, rows.reshape(-1), contrib.reshape(-1, d))
    ye = _expert_ffn(buf.reshape(g, e_pad * r.cap, d), p, g, e_pad, r.cap, d)

    # combine: gather each pair's row back, weighted sum over k in f32
    gathered = torch.gather(ye, 1, r.slot.reshape(g, gs * k, 1).expand(g, gs * k, d))
    gathered = gathered.reshape(g, gs, k, d).float()
    w = (r.top_p * r.keep).float()
    out = torch.einsum("gsk,gskd->gsd", w, gathered).reshape(b, s, d).to(x.dtype)
    if cfg.moe_shared_expert:
        out = out + swiglu(p["shared"], x)

    # Switch-style load-balancing loss
    me = torch.mean(r.onehot.sum(2).float(), dim=1)  # routed fraction per expert
    ce = torch.mean(r.probs, dim=1)
    aux = (e / max(k, 1)) * torch.mean(torch.sum(me * ce, dim=-1))
    return out, aux


def moe_init(cfg, gen: torch.Generator, *, lead: tuple = (), device=None) -> dict:
    """Router (scale 0.02) and the stacked experts ``[*lead, E_pad, d, ff]``
    (every expert matrix scaled by d_model^-0.5, as the reference's), plus
    the always-on shared SwiGLU expert where the config has one; the
    reference's keys and layout, seeded torch draws."""
    e_pad, d, ff = cfg.padded_experts, cfg.d_model, cfg.d_ff
    lead_e = (*lead, e_pad)
    scale = d ** -0.5
    p = {
        "router": dense_init(gen, d, e_pad, lead=lead, scale=0.02, device=device),
        "gate": dense_init(gen, d, ff, lead=lead_e, scale=scale, device=device)["w"],
        "up": dense_init(gen, d, ff, lead=lead_e, scale=scale, device=device)["w"],
        "down": dense_init(gen, ff, d, lead=lead_e, scale=scale, device=device)["w"],
    }
    if cfg.moe_shared_expert:
        p["shared"] = {name: dense_init(gen, a, c, lead=lead, device=device)
                       for name, a, c in (("gate", d, ff), ("up", d, ff), ("down", ff, d))}
    return p
