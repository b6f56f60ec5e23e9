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

__all__ = ["ssd_chunked", "ssd_chunked_backward", "ssd_scan_ref"]


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


def ssd_chunked_backward(xh, dt, a, B, C, dy, dstate, chunk: int = 128):
    """The gradient of ``ssd_chunked`` by hand: (dxh, ddt, da, dB, dC) in
    f32 for the cotangents ``dy`` [b, s, nh, hd] of y and ``dstate`` [b,
    nh, hd, ns] of the final state (either may be None: zero).  Each step
    of the forward is run again (the decays, C.B^T, the chunk states and
    the carry), then taken back in reverse: the off-diagonal read, the
    inter-chunk recurrence (a reverse loop over chunks), the chunk states,
    the within-chunk block, the cumulative decay sums.  Rows the forward
    pads (dt = 0, x = 0) are sliced off; above the diagonal the decay is
    exp(-inf) = 0, so no gradient (and no NaN) flows there."""
    b, s, nh, hd = xh.shape
    ns = B.shape[-1]
    dev = xh.device
    l = min(chunk, s)
    pad = -s % l
    nc = (s + pad) // l

    def chunks(t, *tail):  # f32, padded with zeros to nc chunks of l rows
        t = torch.nn.functional.pad(t.float(), (0, 0) * len(tail) + (0, pad))
        return t.reshape(b, nc, l, *tail)

    xc, dtc = chunks(xh, nh, hd), chunks(dt, nh)
    Bc, Cc = chunks(B, ns), chunks(C, ns)
    g = chunks(dy, nh, hd) if dy is not None else torch.zeros_like(xc)
    a32 = a.float()

    # the forward again, keeping what the backward reads
    da_h = (dtc * a32).movedim(-1, 2)                  # [b, nc, nh, l]
    cum = torch.cumsum(da_h, dim=-1)
    xbar = xc * dtc[..., None]                         # [b, nc, l, nh, hd]
    L = torch.exp(_segsum(da_h))                       # [b, nc, nh, l, l]
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)       # [b, nc, l, l]
    w = torch.exp(cum[..., -1:] - cum)                 # decay to the chunk's end
    xw = xbar * w.movedim(-1, 2)[..., None]
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc, xw)  # [b, nc, nh, hd, ns]
    e = torch.exp(cum[..., -1])                        # [b, nc, nh]
    carry = torch.zeros((b, nh, hd, ns), dtype=torch.float32, device=dev)
    prior = []
    for c in range(nc):
        prior.append(carry)
        carry = carry * e[:, c, :, None, None] + states[:, c]
    prior = torch.stack(prior, dim=1)                  # [b, nc, nh, hd, ns]

    # (4) y_off[i] = exp(cum[i]) * C[i] . prior
    gs = g * torch.exp(cum).movedim(-1, 2)[..., None]  # [b, nc, l, nh, hd]
    dprior = torch.einsum("bcihp,bcin->bchpn", gs, Cc)
    dC = torch.einsum("bcihp,bchpn->bcin", gs, prior)
    dcum = (gs * torch.einsum("bcin,bchpn->bcihp", Cc, prior)).sum(-1).movedim(-1, 2)

    # (3) the carry: S_c = S_{c-1} * e_c + states_c, prior_c = S_{c-1}
    dS = (torch.zeros_like(carry) if dstate is None else dstate.float())
    dstates, de = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = dS
        de[c] = (dS * prior[:, c]).sum((-1, -2))
        dS = dS * e[:, c, :, None, None] + dprior[:, c]
    dstates = torch.stack(dstates, dim=1)
    dcum[..., -1] += torch.stack(de, dim=1) * e

    # (2) states = sum_j B[j] (x) w[j] xbar[j]
    db_x = torch.einsum("bchpn,bcjn->bcjhp", dstates, Bc)  # [b, nc, l, nh, hd]
    dxbar = db_x * w.movedim(-1, 2)[..., None]
    dB = torch.einsum("bcjhp,bchpn->bcjn", xw, dstates)
    dw = (db_x * xbar).sum(-1).movedim(-1, 2) * w          # [b, nc, nh, l]
    dcum -= dw
    dcum[..., -1] += dw.sum(-1)

    # (1) y_diag[i] = sum_j cb[i, j] L[i, j] xbar[j]
    dxbar += torch.einsum("bchij,bcihp->bcjhp", cb[:, :, None] * L, g)
    dm = torch.einsum("bcihp,bcjhp->bchij", g, xbar).mul_(L)  # d(cb L) * L
    dcb = dm.sum(2)
    dC += torch.einsum("bcij,bcjn->bcin", dcb, Bc)
    dB += torch.einsum("bcij,bcin->bcjn", dcb, Cc)
    dseg = dm.mul_(cb[:, :, None])                     # dL * L, 0 above the diagonal
    dcum += dseg.sum(-1) - dseg.sum(-2)

    # cum = cumsum(dt * a); xbar = x * dt
    dda = dcum.flip(-1).cumsum(-1).flip(-1).movedim(2, -1)  # [b, nc, l, nh]
    ddt = dda * a32 + (dxbar * xc).sum(-1)
    da = (dda * dtc).sum((0, 1, 2))
    dx = dxbar * dtc[..., None]

    def rows(t):
        return t.reshape(b, nc * l, *t.shape[3:])[:, :s]

    return rows(dx), rows(ddt), da, rows(dB), rows(dC)


def ssd_scan_ref(x, dt, a, B, C, d_skip, *, chunk: int = 128):
    """The kernel's contract: y [b, s, nh, hd] in x.dtype (with the D skip
    term), final state [b, nh, hd, ns] f32."""
    y, state = ssd_chunked(x, dt, a, B, C, chunk)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state
