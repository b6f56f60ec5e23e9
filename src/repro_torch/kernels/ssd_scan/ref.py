"""Plain PyTorch version of the ssd_scan kernel: the port's own copy of
``repro.models.ssm._ssd_chunked`` (Mamba-2 SSD, chunked: within-chunk
decay-masked scores, per-chunk summary states, the inter-chunk
recurrence) plus the D skip term of ``repro.kernels.ssd_scan.ref``.

Unlike the reference, any ``s`` is accepted: the last chunk is padded
with ``dt = 0`` and ``x = 0``.  Those rows neither decay the state
(exp(0·a) = 1) nor add to it (x̄ = 0), so the result is exact, and the
padded rows of y are dropped.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_chunked", "ssd_scan_ref"]


def _segsum(a):
    """a: [..., T] log-decays -> [..., T, T] lower-triangular cumulative
    sums (-inf above the diagonal, so exp gives 0 there)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, a, B, C, chunk: int = 128):
    """xh [b, s, nh, hd]; dt [b, s, nh] (post-softplus); a [nh] (negative);
    B, C [b, s, ns] (one group, shared across heads) -> y [b, s, nh, hd]
    f32 without the D term, final state [b, nh, hd, ns] f32."""
    b, s, nh, hd = xh.shape
    ns = B.shape[-1]
    l = min(chunk, s)
    pad = -s % l
    if pad:
        xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // l

    xc = xh.reshape(b, nc, l, nh, hd).float()
    dtc = dt.reshape(b, nc, l, nh).float()
    Bc = B.reshape(b, nc, l, ns).float()
    Cc = C.reshape(b, nc, l, ns).float()

    da_h = (dtc * a.float()).movedim(-1, 2)        # [b, nc, nh, l] log-decay per step
    da_cum = torch.cumsum(da_h, dim=-1)
    xbar = xc * dtc[..., None]                     # dt-scaled inputs

    # (1) within-chunk (diagonal blocks): attention-like with decay kernel
    L = torch.exp(_segsum(da_h))                   # [b, nc, nh, l, l]
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_diag = torch.einsum("bchij,bcjhp->bcihp", cb[:, :, None] * L, xbar)

    # (2) per-chunk summary states: decay to end-of-chunk
    decay_states = torch.exp(da_cum[..., -1:] - da_cum)      # [b, nc, nh, l]
    states = torch.einsum("bcjn,bchj,bcjhp->bchpn", Bc, decay_states, xbar)

    # (3) inter-chunk recurrence, emitting the state before each chunk
    chunk_decay = torch.exp(da_cum[..., -1])                 # [b, nc, nh]
    carry = torch.zeros((b, nh, hd, ns), dtype=torch.float32, device=xh.device)
    prior = []
    for c in range(nc):
        prior.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prior_states = torch.stack(prior, dim=1)                 # [b, nc, nh, hd, ns]

    # (4) off-diagonal contribution: read prior state with in-chunk decay
    state_decay = torch.exp(da_cum)
    y_off = torch.einsum("bcin,bchi,bchpn->bcihp", Cc, state_decay, prior_states)

    y = (y_diag + y_off).reshape(b, nc * l, nh, hd)[:, :s]
    return y, carry


def ssd_scan_ref(x, dt, a, B, C, d_skip, *, chunk: int = 128):
    """The kernel's contract: y [b, s, nh, hd] in x.dtype (with the D skip
    term), final state [b, nh, hd, ns] f32."""
    y, state = ssd_chunked(x, dt, a, B, C, chunk)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state
