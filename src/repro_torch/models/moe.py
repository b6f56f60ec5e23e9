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
router logits and are never chosen.

Under a mesh (``models.sharding``) the group size follows the reference's
rule over the GLOBAL token count (the group count divisible by the DP
extent where it can be), and ``_expert_ffn`` is the reference's
expert-parallel ``shard_map`` branch (``moe.py:62-129``) under the same
conditions: each rank takes its groups' buffers (its slice over the DP
axes), one ``all_to_all`` over 'data' sends each expert's rows to the rank
that holds it, the rank's experts run, one ``all_to_all`` brings the rows
back; an f32 sum over 'model' when the FFN is tensor parallel
(``ff_sharded``); the expert weights gathered over 'model' when they are
FSDP there (the folded DP+EP deployment) or a TP shard too narrow to pay.
Otherwise each rank runs its own experts on its tokens' buffers and the
results are gathered over 'data'.

Training (the gradient convention of ``models.sharding``): every
exchange is differentiable (the all_to_alls' backward the inverse
exchange, the gathered expert halves' a reduce-scatter, the TP sum's the
identity).  Under tensor parallelism the model ranks hold the same
buffers: the expert input goes through ``copy_to_model`` when the
experts' d_ff is split over 'model', and where each model rank then runs
the experts whole (the halves gathered) their output's gradient is shared
among the model ranks, so that the reduce-scatter and that copy count it
once.  Where a group spans ranks (its rows gathered) the aux loss is
computed alike on every one of them, and its gradient is shared so too.
The router's gradient is summed over the DP axes with the other
replicated leaves (``launch.steps``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import sharding
from repro_torch.models.layers import dense_init, swiglu

__all__ = ["Routing", "capacity", "group_size", "moe_route", "moe_apply", "moe_init"]


def capacity(tokens_per_group: int, k: int, e: int, cf: float) -> int:
    return max(1, -(-int(tokens_per_group * k * cf) // e))


def group_size(n: int, dp: int = 1, preferred: int = 512) -> int:
    """Tokens a group: the first of the reference's candidates that divides
    the ``n`` tokens with a group count divisible by the ``dp`` ranks of
    the data-parallel axes, else (degenerate small inputs) all of them in
    one group, or n / dp each when dp divides n."""
    for cand in (preferred, 512, 256, 128, 64, 32):
        if cand <= n and n % cand == 0 and (n // cand) % dp == 0:
            return cand
    return n if n % dp else n // dp


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


def _ffn_local(xe, gate, up, down):
    """Per-expert SwiGLU over buffers.  xe: [E, n, d]."""
    return torch.bmm(F.silu(torch.bmm(xe, gate)) * torch.bmm(xe, up), down)


def _expert_weights(p, ff: int):
    """This rank's expert weights with the d_ff its products contract, and
    whether their results need a sum over 'model': the reference's
    ``ff_sharded`` (TP over 'model' with at least 128 columns a rank) keeps
    the local columns; a d_ff split any other way (FSDP over 'model' in the
    folded deployment, or a TP shard too narrow to pay) is gathered."""
    gate, up, down = p["gate"], p["up"], p["down"]
    tp = sharding.tp_size()
    ff_sharded = tp > 1 and ff % tp == 0 and ff // tp >= 128
    if gate.shape[-1] < ff and not ff_sharded:
        gate = sharding.all_gather(gate, "model", -1)
        up = sharding.all_gather(up, "model", -1)
        down = sharding.all_gather(down, "model", -2)
    return gate, up, down, gate.shape[-1] < ff


def _tp_output(y, psum: bool, tp_split: bool, dtype):
    """The experts' output under TP: the model ranks' partial products
    over their d_ff columns summed in f32 (``psum``), or, when every model
    rank ran the gathered experts whole on the same buffers (``tp_split``
    without ``psum``), the value they computed alike, its gradient shared."""
    if psum:
        return sharding.all_reduce(y.float(), "model").to(dtype)
    return sharding.share_grad(y, "model") if tp_split else y


def _expert_ffn(buf, p, g, e_pad, cap, d, ff, batch_axes=()):
    """Per-expert SwiGLU over the buffers of this rank's groups: [g_l, E*C,
    d] -> the same.  ``g`` counts the groups of the whole batch, split over
    ``batch_axes`` (a prefix of the DP axes) into this rank's ``g_l``."""
    g_l = buf.shape[0]
    # the experts' d_ff split over TP ranks that hold the same buffers: the
    # buffers are a column-parallel product's input
    tp_split = sharding.tp_size() > 1 and p["gate"].shape[-1] < ff
    if tp_split:
        buf = sharding.copy_to_model(buf)
    gate, up, down, psum = _expert_weights(p, ff)
    dsize = sharding.axis_size("data")
    if sharding.get_mesh() is None or g % sharding.dp_size() or e_pad % dsize or dsize == 1:
        # each rank's experts (E over 'data' where it divides) on its buffers;
        # the ranks along 'data' hold the same buffers here: ``group_size``
        # leaves g a multiple of the DP extent or 1, and one group is whole
        e_loc = gate.shape[0]
        lo = sharding.axis_index("data") * e_loc if e_loc < e_pad else 0
        xe = buf.reshape(g_l, e_pad, cap, d).transpose(0, 1)[lo:lo + e_loc]
        ye = _tp_output(_ffn_local(xe.reshape(e_loc, g_l * cap, d), gate, up, down), psum,
                        tp_split, buf.dtype)
        if e_loc < e_pad:
            ye = sharding.all_gather(ye, "data", 0)
        return ye.reshape(e_pad, g_l, cap, d).transpose(0, 1).reshape(g_l, e_pad * cap, d)

    # expert parallel: the rank's groups over every DP axis (its batch rows
    # cover the DP axes outside batch_axes too: take its part of them)
    rest = tuple(a for a in sharding.dp_axes() if a not in batch_axes)
    mine = sharding.take_shard(buf, rest, 0)
    e_loc = e_pad // dsize
    y = sharding.all_to_all(mine, "data", split_dim=1, concat_dim=0)
    rows = y.shape[0]
    y = y.reshape(rows, e_loc, cap, d).transpose(0, 1).reshape(e_loc, rows * cap, d)
    out = _tp_output(_ffn_local(y, gate, up, down), psum, tp_split, buf.dtype)
    out = out.reshape(e_loc, rows, cap, d).transpose(0, 1).reshape(rows, e_loc * cap, d)
    out = sharding.all_to_all(out, "data", split_dim=0, concat_dim=1)
    return sharding.all_gather(out, rest, 0)


def moe_apply(p, x: torch.Tensor, cfg, *, group_size_pref: int = 512, batch_axes=()):
    """x: [b, s, d] -> (out [b, s, d], aux load-balance loss, f32 scalar).
    Under a mesh x holds this rank's batch rows, split over ``batch_axes``
    (a prefix of the DP axes; none: every rank holds the whole batch)."""
    b, s, d = x.shape
    e_pad, e, k = cfg.padded_experts, cfg.num_experts, cfg.experts_per_token
    split = sharding.axis_size(batch_axes)
    n = b * s * split                    # tokens of the whole batch
    gs = group_size(n, sharding.dp_size(), group_size_pref)
    g = n // gs
    spread = ()
    if split > 1 and g % split:          # a group spans ranks: gather its rows
        spread, x = batch_axes, sharding.all_gather(x, batch_axes, 0)
        b, split, batch_axes = x.shape[0], 1, ()
    xg = x.reshape(-1, gs, d)
    g_l = xg.shape[0]
    r = moe_route(p, xg, cfg, capacity(gs, k, e, cfg.capacity_factor))

    # dispatch: every kept pair into its own buffer row
    contrib = torch.where(r.keep[..., None], xg[:, :, None, :], 0).to(x.dtype)
    rows = r.slot + (torch.arange(g_l, device=x.device) * (e_pad * r.cap))[:, None, None]
    buf = torch.zeros((g_l * e_pad * r.cap, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, rows.reshape(-1), contrib.reshape(-1, d))
    ye = _expert_ffn(buf.reshape(g_l, e_pad * r.cap, d), p, g, e_pad, r.cap, d, cfg.d_ff,
                     batch_axes)

    # combine: gather each pair's row back, weighted sum over k in f32
    gathered = torch.gather(ye, 1, r.slot.reshape(g_l, gs * k, 1).expand(g_l, gs * k, d))
    gathered = gathered.reshape(g_l, gs, k, d).float()
    w = (r.top_p * r.keep).float()
    out = torch.einsum("gsk,gskd->gsd", w, gathered).reshape(b, s, d).to(x.dtype)
    if cfg.moe_shared_expert:
        out = out + swiglu(p["shared"], x, cfg.d_ff)

    # Switch-style load-balancing loss, a mean over every group of the batch
    me = torch.mean(r.onehot.sum(2).float(), dim=1)  # routed fraction per expert
    ce = torch.mean(r.probs, dim=1)
    aux = (e / max(k, 1)) * torch.mean(torch.sum(me * ce, dim=-1))
    if split > 1:
        aux = sharding.all_reduce(aux, batch_axes) / split
    aux = sharding.share_grad(aux, spread)
    return sharding.take_shard(out, spread, 0), aux


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
