"""Mamba-2 SSD block — chunked prefill + O(1) decode, the port of
``src/repro/models/ssm.py``.

Prefill runs the SSD scan through the hand-written ``ssd_scan`` kernel
(``kernels/ssd_scan/ops.py``; the plain version on CPU tensors), which
takes any sequence length and already adds the D skip term.  The block
returns its FINAL STATE from prefill: that state (plus the depthwise-conv
tail) is what KVDirect transfers to the decode worker for SSM
architectures (one contiguous slot per layer; see
``serving.kv_cache.SlotCache``).  The conv keeps the activations' dtype
(bf16 at full width), the SSD runs in f32.

Under tensor parallelism (``models.sharding``; params from
``launch.shardings.shard_params``) the block splits as its decode state
does (``launch.shardings.decode_state_sharding``): over the SSD heads
when they divide the 'model' axis (mamba2-780m: 48 heads, 12 a rank at
4), else over ``head_dim`` (hymba-1.5b: 50 heads, each rank a slice of
64 / 4 = 16 channels of every head; the SSD is exact channel by channel).
The placement rules cut across the block's structure, so the block
writes out these collectives (each a layer, each counted):

  * ``in_proj``'s output (column-parallel over its 2·di + 2·ns + nh
    columns, which cut across z | xBC | dt) is gathered whole over
    'model' (an all_gather; its backward a reduce-scatter);
  * the depthwise conv runs over every channel on every rank (B and C,
    which every head needs, live in the last ranks' columns); its tail is
    stored as the rank's contiguous slice of the c = di + 2·ns channels,
    the rule's, and gathered whole again before a decode step's conv;
  * the SSD runs on the rank's heads (or ``head_dim`` slice), its final
    state being exactly the rank's shard of ``ssd_state``;
  * heads: the gated RMSNorm over all of di needs the sum of squares
    over 'model' (an f32 all_reduce of [.., 1]), and ``out_proj``'s rows
    are the rank's heads, so it contracts the rank's y as it is;
    ``head_dim``: y is gathered over 'model' (an all_gather of di
    columns), normed whole, and ``out_proj`` takes its contiguous rows;
  * ``out_proj``'s partial products are summed over 'model'.

One device runs the same code: there every collective and shard above is
a no-op (the rank's heads are all heads, its slices whole).

For training, every leaf the placement keeps whole on the 'model' ranks
(the conv, ``a_log``, ``dt_bias``, ``d_skip``, the norm's scale) goes
through ``copy_to_model``, as does the block's input: each rank's
gradient of them is its own heads' part, summed over 'model' in the
backward; the sum of squares takes an all_reduce both ways (its value is
used rank by rank).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import sharding
from repro_torch.models.layers import dense, rmsnorm, row_dense

__all__ = ["pack_ssm_slot", "ssm_prefill", "ssm_slot_elems", "ssm_state_shapes", "ssm_step",
           "split_mode", "unpack_ssm_slots"]


def ssm_state_shapes(cfg, batch: int):
    """(ssd_state, conv_state) shapes for serving allocation/transfer."""
    di, ns = cfg.ssm_inner, cfg.ssm_state
    return (
        (batch, cfg.ssm_heads, cfg.ssm_head_dim, ns),
        (batch, cfg.ssm_conv - 1, di + 2 * ns),
    )


def ssm_slot_elems(cfg) -> int:
    """Elements of one sequence's state slot per layer (``SlotCache``'s
    ``state_elems``): the SSD state, then the conv tail."""
    return sum(math.prod(shape) for shape in ssm_state_shapes(cfg, 1))


def pack_ssm_slot(ssd_state, conv_state) -> torch.Tensor:
    """One sequence's layer state (ssd [nh,hd,ns], conv [k-1,c]) -> the
    flat f32 row of its slot: the SSD state flattened, then the conv tail
    cast to f32 (a bf16 slot would round the f32 SSD state)."""
    return torch.cat([ssd_state.float().reshape(-1), conv_state.float().reshape(-1)])


def unpack_ssm_slots(rows, cfg, conv_dtype):
    """[b, slot elems] rows -> (ssd_state [b,nh,hd,ns] f32, conv_state
    [b,k-1,c] in ``conv_dtype``); the inverse of ``pack_ssm_slot``."""
    ssd_shape, conv_shape = ssm_state_shapes(cfg, rows.shape[0])
    n = math.prod(ssd_shape[1:])
    return (rows[:, :n].float().reshape(ssd_shape),
            rows[:, n:].reshape(conv_shape).to(conv_dtype))


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv, kernel k.  xbc: [b, s, c]; conv_w: [k, c].
    Returns output [b, s, c] and the new conv tail [b, k-1, c]."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[-1]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [b, s+k-1, c]
    s = xbc.shape[1]
    out = sum(xp[:, i : i + s, :] * conv_w[i].to(xbc.dtype) for i in range(k)) \
        + conv_b.to(xbc.dtype)
    new_tail = xp[:, -(k - 1) :, :]
    return F.silu(out), new_tail


def split_mode(cfg) -> str | None:
    """How the block splits over 'model' under tensor parallelism, as its
    decode state's placement does: "heads" when the SSD heads divide TP,
    else "head_dim" when the head dim does, else None (no split; also
    without TP)."""
    tp = sharding.tp_size()
    if tp == 1:
        return None
    if cfg.ssm_heads % tp == 0 and cfg.ssm_heads >= tp:
        return "heads"
    if cfg.ssm_head_dim % tp == 0 and cfg.ssm_head_dim >= tp:
        return "head_dim"
    return None


class _TP:
    """One call's view of the block under tensor parallelism: the params as
    the rank computes with them (whole leaves through ``copy_to_model``),
    its heads and head-dim slice, and the collectives around the SSD.
    Without TP: every head and channel, and no collective."""

    def __init__(self, p, cfg):
        self.cfg, self.mode = cfg, split_mode(cfg)
        tp = self.tp = sharding.tp_size()
        r = sharding.axis_index("model") if tp > 1 else 0   # a folded axis is not TP
        di, ns, nh, hd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
        whole = {"conv_w", "conv_b", "a_log", "dt_bias", "d_skip"}
        q = {k: sharding.copy_to_model(v) if k in whole else v for k, v in p.items()}
        q["out_norm"] = {"scale": sharding.copy_to_model(p["out_norm"]["scale"])}
        for name, dim, full in (("in_proj", -1, 2 * di + 2 * ns + nh), ("out_proj", -2, di)):
            if p[name]["w"].shape[dim] == full:   # left whole by the placement
                q[name] = {k: sharding.copy_to_model(v) for k, v in p[name].items()}
        self.p = q
        self.heads = slice(r * nh // tp, (r + 1) * nh // tp) if self.mode == "heads" \
            else slice(0, nh)
        self.cols = slice(r * hd // tp, (r + 1) * hd // tp) if self.mode == "head_dim" \
            else slice(0, hd)
        self.c = di + 2 * ns
        self.conv_split = tp > 1 and self.c % tp == 0   # the conv tail's placement

    def project(self, x):
        """The whole [z | xBC | dt] on every rank from the block's input."""
        cfg = self.cfg
        zxbcdt = dense(self.p["in_proj"], sharding.copy_to_model(x))
        if zxbcdt.shape[-1] < 2 * cfg.ssm_inner + 2 * cfg.ssm_state + cfg.ssm_heads:
            zxbcdt = sharding.all_gather(zxbcdt, "model", -1)
        di, ns = cfg.ssm_inner, cfg.ssm_state
        return zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * ns], zxbcdt[..., 2 * di + 2 * ns:]

    def heads_of(self, xs, dt_raw):
        """(x [..., nh_l, hd_l], dt [..., nh_l] post-softplus, a [nh_l],
        d_skip [nh_l]) of the rank's heads and head-dim slice."""
        cfg, p = self.cfg, self.p
        xh = xs.reshape(*xs.shape[:-1], cfg.ssm_heads, cfg.ssm_head_dim)[
            ..., self.heads, self.cols]
        dt = F.softplus(dt_raw.float()[..., self.heads] + p["dt_bias"][self.heads])
        return xh, dt, -torch.exp(p["a_log"][self.heads]), p["d_skip"][self.heads].float()

    def store_conv(self, tail):
        """The conv tail whole -> the rank's slice of its channels (its
        placement)."""
        if not self.conv_split:
            return tail
        return sharding.take_shard(tail, "model", -1).contiguous()

    def load_conv(self, conv_state):
        if conv_state.shape[-1] < self.c:
            return sharding.all_gather(conv_state, "model", -1)
        return conv_state

    def out(self, y, z, dtype):
        """y [..., nh_l, hd_l] f32 (with the D term) and z whole -> the
        block's output [..., d], summed over 'model'."""
        cfg, p = self.cfg, self.p
        di = cfg.ssm_inner
        if self.mode == "heads":
            lo = self.heads.start * cfg.ssm_head_dim
            width = y.shape[-2] * cfg.ssm_head_dim
            g = y.reshape(*y.shape[:-2], width).to(dtype) * F.silu(z[..., lo: lo + width])
            h = g.float()
            ss = sharding.all_reduce((h * h).sum(-1, keepdim=True), "model")
            h = h * torch.rsqrt(sharding.copy_to_model(ss) / di + 1e-5)
            scale = p["out_norm"]["scale"][lo: lo + width]
            return row_dense(p["out_proj"], (h * scale.float()).to(dtype), di)
        if self.mode == "head_dim":
            y = sharding.all_gather(y, "model", -1)
        g = rmsnorm(p["out_norm"], y.reshape(*y.shape[:-2], di).to(dtype) * F.silu(z))
        if self.tp > 1 and p["out_proj"]["w"].shape[-2] == di:
            # whole: every rank's share of its gradient
            g = sharding.share_grad(g, "model")
        return row_dense(p["out_proj"], g, di)


def ssm_prefill(p, x, cfg, *, chunk: int = 128, conv_state=None, ssd_state=None):
    """x: [b, s, d] -> (y [b, s, d], (ssd_state, conv_tail)).  With
    ``ssd_state``/``conv_state`` the block continues from a transferred
    state instead of from zeros (one device).  Under tensor parallelism
    the states are the rank's shards (see the module's docstring)."""
    if sharding.tp_size() > 1 and (conv_state is not None or ssd_state is not None):
        raise ValueError("ssm_prefill: continuing from a state runs on one device")
    tp = _TP(p, cfg)
    di, ns = cfg.ssm_inner, cfg.ssm_state
    z, xbc, dt_raw = tp.project(x)
    xbc, conv_tail = _causal_conv(xbc, tp.p["conv_w"], tp.p["conv_b"], conv_state)
    xs, B, C = xbc[..., :di], xbc[..., di: di + ns], xbc[..., di + ns:]
    xh, dt, a, d_skip = tp.heads_of(xs, dt_raw)
    Cf = C.float().contiguous()
    # the kernel's y already holds the D term (ssm.py:159 in the reference)
    y, final = ssd_scan(xh.float().contiguous(), dt.contiguous(), a, B.float().contiguous(),
                        Cf, d_skip, chunk=chunk)
    if ssd_state is not None:  # continue from transferred state
        # fold initial state in: y += C · decay · state0 ; final updated
        da_cum = torch.cumsum((dt * a).movedim(-1, 1), dim=-1)  # [b, nh, s]
        state0 = ssd_state.float()
        y = y + torch.einsum("bsn,bhs,bhpn->bshp", Cf, torch.exp(da_cum), state0)
        final = final + state0 * torch.exp(da_cum[..., -1])[..., None, None]
    return tp.out(y, z, x.dtype), (final, tp.store_conv(conv_tail))


def ssm_step(p, x, cfg, state):
    """One-token decode.  x: [b, d]; state = (ssd_state [b,nh,hd,ns],
    conv_state [b,k-1,c]) -> (y [b, d], new state); under tensor
    parallelism the rank's shards of both."""
    tp = _TP(p, cfg)
    di, ns = cfg.ssm_inner, cfg.ssm_state
    ssd_state, conv_state = state
    z, xbc, dt_raw = (t[:, 0] for t in tp.project(x[:, None, :]))
    # conv step: shift buffer, apply kernel at last position
    window = torch.cat([tp.load_conv(conv_state).to(xbc.dtype), xbc[:, None, :]], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, tp.p["conv_w"].to(xbc.dtype)) \
        + tp.p["conv_b"].to(xbc.dtype)
    xbc = F.silu(conv_out)
    xs, B, C = xbc[..., :di], xbc[..., di: di + ns], xbc[..., di + ns:]
    xh, dt, a, d_skip = tp.heads_of(xs, dt_raw)
    xh = xh.float()
    # state' = decay * state + dt * x ⊗ B ; y = state' · C
    upd = torch.einsum("bhp,bn,bh->bhpn", xh, B.float(), dt)
    new_state = ssd_state.float() * torch.exp(dt * a)[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float()) + xh * d_skip[None, :, None]
    return tp.out(y, z, x.dtype), (new_state, tp.store_conv(window[:, 1:, :]))
