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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import dense, rmsnorm

__all__ = ["pack_ssm_slot", "ssm_prefill", "ssm_slot_elems", "ssm_state_shapes", "ssm_step",
           "unpack_ssm_slots"]


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


def _split(p, x, cfg):
    di, ns = cfg.ssm_inner, cfg.ssm_state
    zxbcdt = dense(p["in_proj"], x)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : 2 * di + 2 * ns]
    dt = zxbcdt[..., 2 * di + 2 * ns :]
    return z, xbc, dt


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


def ssm_prefill(p, x, cfg, *, chunk: int = 128, conv_state=None, ssd_state=None):
    """x: [b, s, d] -> (y [b, s, d], (ssd_state, conv_tail)).  With
    ``ssd_state``/``conv_state`` the block continues from a transferred
    state instead of from zeros."""
    di, ns, nh, hd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw = _split(p, x, cfg)
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, B, C = xbc[..., :di], xbc[..., di : di + ns], xbc[..., di + ns :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])  # [nh], negative
    xh = xs.reshape(*xs.shape[:-1], nh, hd)
    Bf, Cf = B.float().contiguous(), C.float().contiguous()
    # the kernel's y already holds the D term (ssm.py:159 in the reference)
    y, final = ssd_scan(xh.float().contiguous(), dt, a, Bf, Cf, p["d_skip"].float(),
                        chunk=chunk)
    if ssd_state is not None:  # continue from transferred state
        # fold initial state in: y += C · decay · state0 ; final updated
        da_cum = torch.cumsum((dt * a).movedim(-1, 1), dim=-1)  # [b, nh, s]
        decay = torch.exp(da_cum)
        state0 = ssd_state.float()
        y = y + torch.einsum("bsn,bhs,bhpn->bshp", Cf, decay, state0)
        final = final + state0 * torch.exp(da_cum[..., -1])[..., None, None]
    y = y.reshape(*x.shape[:-1], di).to(x.dtype)
    y = rmsnorm(p["out_norm"], y * F.silu(z))
    return dense(p["out_proj"], y), (final, conv_tail)


def ssm_step(p, x, cfg, state):
    """One-token decode.  x: [b, d]; state = (ssd_state [b,nh,hd,ns],
    conv_state [b,k-1,c]) -> (y [b, d], new state)."""
    di, ns, nh, hd = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    ssd_state, conv_state = state
    z, xbc, dt_raw = _split(p, x[:, None, :], cfg)
    z, xbc, dt_raw = z[:, 0], xbc[:, 0], dt_raw[:, 0]

    # conv step: shift buffer, apply kernel at last position
    window = torch.cat([conv_state.to(xbc.dtype), xbc[:, None, :]], dim=1)  # [b,k,c]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(xbc.dtype)) \
        + p["conv_b"].to(xbc.dtype)
    xbc = F.silu(conv_out)
    new_conv = window[:, 1:, :]

    xs, B, C = xbc[..., :di], xbc[..., di : di + ns], xbc[..., di + ns :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [b, nh]
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt * a)  # [b, nh]
    xh = xs.reshape(-1, nh, hd).float()
    # state' = decay * state + dt * x ⊗ B ; y = state' · C
    upd = torch.einsum("bhp,bn,bh->bhpn", xh, B.float(), dt)
    new_state = ssd_state.float() * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, C.float())
    y = y + xh * p["d_skip"][None, :, None]
    y = y.reshape(-1, di).to(x.dtype)
    y = rmsnorm(p["out_norm"], y * F.silu(z))
    return dense(p["out_proj"], y), (new_state, new_conv)
