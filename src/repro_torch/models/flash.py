"""Blockwise (flash) attention with a backward — the port of
``src/repro/models/flash.py``.

Without gradients, ``flash_attention`` is one launch of the hand-written
``flash_prefill`` kernel (``kernels/flash_prefill/ops.py``), which masks
ragged lengths itself: no chunk alignment is needed.  With gradients it
is ``FlashAttention``, a ``torch.autograd.Function`` after the reference's
custom VJP (``flash.py:171-195``): the forward saves (q, k, v, out, lse),
where lse is each row's log-sum-exp of its scaled scores, and the
backward recomputes the softmax from lse block by block over
``pair_schedule`` (``_bwd_scan``, after ``flash.py:121-169``), so nothing
of size [s, t] outlives a block pair.  On the card the forward is the
kernel with its ``lse`` output (on meta tensors the kernel wrapper's
shapes); on the CPU it is ``_fwd_scan``, the port of
``flash.py:76-119``.  The backward is plain torch on both: the
reference's is jnp, not a Pallas kernel.

Two departures from the reference, both where a row sees no key at all
(never on a causal or full path; only padding): exponentials are taken
only where a key is visible (``exp`` of a masked score gives 0, not the
reference's uniform weights), so such a row's output is 0 and its lse
is -inf, as the kernel gives; and any s and t are taken, the blocks of
the last chunk padded with rows that see nothing and keys no row sees.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill.ops import flash_prefill

__all__ = ["FlashAttention", "flash_attention", "flash_forward_plain", "pair_schedule"]

NEG_INF = -1e30


def pair_schedule(
    s: int, t: int, q_chunk: int, k_chunk: int,
    *, causal: bool, window: int = 0, prefix: int = 0, q_offset: int = 0,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Static (i, j) block pairs that contain ≥1 visible (q, k) position.

    q position of chunk i spans [q_offset + i·cq, q_offset + (i+1)·cq);
    k position of chunk j spans [j·ck, (j+1)·ck).  Visibility:
    k ≤ q (causal) ∧ (k > q − window ∨ k < prefix) (sliding window).
    """
    pi, pj = [], []
    nq, nk = s // q_chunk, t // k_chunk
    for i in range(nq):
        q_lo = q_offset + i * q_chunk
        q_hi = q_lo + q_chunk - 1
        for j in range(nk):
            k_lo = j * k_chunk
            k_hi = k_lo + k_chunk - 1
            if causal and k_lo > q_hi:
                continue  # fully in the future
            if window:
                fully_out = k_hi <= q_lo - window
                covers_prefix = prefix > 0 and k_lo < prefix
                if fully_out and not covers_prefix:
                    continue
            pi.append(i)
            pj.append(j)
    return tuple(pi), tuple(pj)


def _block_mask(i, j, cq, ck, s, t, causal, window, prefix, device):
    """[cq, ck] visibility of block pair (i, j); rows at or past s and keys
    at or past t (the padding of a ragged last chunk) see nothing."""
    qp = (i * cq + torch.arange(cq, device=device))[:, None]
    kp = (j * ck + torch.arange(ck, device=device))[None, :]
    m = (qp < s) & (kp < t)
    if causal:
        m = m & (kp <= qp)
    if window:
        vis = kp > qp - window
        if prefix:
            vis = vis | (kp < prefix)
        m = m & vis
    return m


class _Blocks:
    """The block layout of one call: grouped, padded operands and the pair
    schedule.  q [b, s, h, d] -> [b, g, qpg, s_pad, d]; k, v [b, t, g, d]
    -> [b, g, t_pad, d]."""

    def __init__(self, q, k, causal, window, prefix, q_chunk, k_chunk):
        b, s, h, d = q.shape
        t, g = k.shape[1], k.shape[2]
        self.b, self.s, self.t, self.h, self.g, self.d = b, s, t, h, g, d
        self.qpg = h // g
        self.cq, self.ck = min(q_chunk, s), min(k_chunk, t)
        self.s_pad = -(-s // self.cq) * self.cq
        self.t_pad = -(-t // self.ck) * self.ck
        self.causal, self.window, self.prefix = causal, window, prefix
        self.pairs = list(zip(*pair_schedule(self.s_pad, self.t_pad, self.cq, self.ck,
                                             causal=causal, window=window, prefix=prefix)))

    def q(self, x):  # [b, s, h, d] -> [b, g, qpg, s_pad, d]
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, self.s_pad - self.s))
        return x.reshape(self.b, self.s_pad, self.g, self.qpg, self.d).permute(0, 2, 3, 1, 4)

    def kv(self, x):  # [b, t, g, d] -> [b, g, t_pad, d]
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, self.t_pad - self.t)).transpose(1, 2)

    def unq(self, x):  # [b, g, qpg, s_pad, d] -> [b, s, h, d]
        return x.permute(0, 3, 1, 2, 4).reshape(self.b, self.s_pad, self.h, self.d)[:, :self.s]

    def unkv(self, x):  # [b, g, t_pad, d] -> [b, t, g, d]
        return x.transpose(1, 2)[:, :self.t]

    def mask(self, i, j, device):
        return _block_mask(i, j, self.cq, self.ck, self.s, self.t, self.causal, self.window,
                           self.prefix, device)


def _fwd_scan(q, k, v, blk: _Blocks):
    """The port of ``flash.py::_fwd_scan``: q [b, s, h, d]; k, v [b, t, g,
    d] -> (out [b, s, h, d] in q.dtype, lse [b, h, s] f32)."""
    cq, ck, d = blk.cq, blk.ck, blk.d
    qg, kg, vg = blk.q(q), blk.kv(k), blk.kv(v)
    scale = d ** -0.5
    lead = qg.shape[:3]
    nq = blk.s_pad // cq
    m = [torch.full((*lead, cq), NEG_INF, device=q.device) for _ in range(nq)]
    l = [torch.zeros((*lead, cq), device=q.device) for _ in range(nq)]
    acc = [torch.zeros((*lead, cq, d), device=q.device) for _ in range(nq)]
    for i, j in blk.pairs:
        qi = qg[:, :, :, i * cq:(i + 1) * cq]
        kj, vj = kg[:, :, j * ck:(j + 1) * ck], vg[:, :, j * ck:(j + 1) * ck]
        sij = torch.einsum("bgqcd,bgkd->bgqck", qi, kj).float() * scale
        mask = blk.mask(i, j, q.device)
        sij = torch.where(mask, sij, NEG_INF)
        mi = torch.maximum(m[i], sij.amax(-1))
        p = torch.where(mask, torch.exp(sij - mi[..., None]), 0.0)
        corr = torch.exp(m[i] - mi)
        l[i] = l[i] * corr + p.sum(-1)
        acc[i] = acc[i] * corr[..., None] + torch.einsum(
            "bgqck,bgkd->bgqcd", p.to(v.dtype), vj).float()
        m[i] = mi
    m, l, acc = torch.cat(m, -1), torch.cat(l, -1), torch.cat(acc, -2)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    lse = m + torch.log(l)  # -inf where a row saw no key
    lse = lse.reshape(blk.b, blk.h, blk.s_pad)[:, :, :blk.s]
    return blk.unq(out).to(q.dtype), lse


def _bwd_scan(q, k, v, out, lse, dout, blk: _Blocks):
    """The port of ``flash.py::_bwd_scan``: P recomputed from q, k and the
    saved lse, then dV, dP, dS = P ∘ (dP − rowsum(dO ∘ O)), dQ and dK, all
    in f32 over the block pairs, cast to the inputs' dtypes at the end."""
    cq, ck, d = blk.cq, blk.ck, blk.d
    scale = d ** -0.5
    qg, kg, vg = blk.q(q), blk.kv(k), blk.kv(v)
    do = blk.q(dout).float()
    delta = (do * blk.q(out).float()).sum(-1)                        # [b, g, qpg, s_pad]
    lse_g = torch.nn.functional.pad(lse, (0, blk.s_pad - blk.s), value=float("-inf"))
    lse_g = lse_g.reshape(qg.shape[:4])
    dq = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kg.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vg.shape, dtype=torch.float32, device=q.device)
    for i, j in blk.pairs:
        qs, ks = slice(i * cq, (i + 1) * cq), slice(j * ck, (j + 1) * ck)
        qi, kj, vj = qg[:, :, :, qs], kg[:, :, ks], vg[:, :, ks]
        do_i, dl_i = do[:, :, :, qs], delta[:, :, :, qs]
        sij = torch.einsum("bgqcd,bgkd->bgqck", qi, kj).float() * scale
        mask = blk.mask(i, j, q.device)
        # exponentials only where visible: a masked score, or a row whose
        # lse is -inf, must give 0 and not exp(-inf + inf) = NaN
        p = torch.where(mask, torch.exp(sij - lse_g[:, :, :, qs, None]), 0.0)
        dv[:, :, ks] += torch.einsum("bgqck,bgqcd->bgkd", p, do_i)
        dp = torch.einsum("bgqcd,bgkd->bgqck", do_i, vj.float())
        ds = p * (dp - dl_i[..., None]) * scale
        dq[:, :, :, qs] += torch.einsum("bgqck,bgkd->bgqcd", ds, kj.float())
        dk[:, :, ks] += torch.einsum("bgqck,bgqcd->bgkd", ds, qi.float())
    return (blk.unq(dq).to(q.dtype), blk.unkv(dk).to(k.dtype), blk.unkv(dv).to(v.dtype))


def flash_forward_plain(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                        prefix_len: int = 0, q_chunk: int = 1024, k_chunk: int = 1024):
    """The plain blockwise forward: (out [b, s, h, d], lse [b, h, s] f32),
    the values the kernel's ``return_lse`` call must give."""
    blk = _Blocks(q, k, causal, sliding_window, prefix_len, q_chunk, k_chunk)
    return _fwd_scan(q, k, v, blk)


class FlashAttention(torch.autograd.Function):
    """GQA flash attention with the reference's custom VJP: q [b, s, h, d];
    k, v [b, t, g, d] -> [b, s, h, d]."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, prefix, q_chunk, k_chunk):
        blk = _Blocks(q, k, causal, window, prefix, q_chunk, k_chunk)
        if q.is_cuda or q.is_meta:
            out, lse = flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                                     causal=causal, sliding_window=window,
                                     prefix_len=prefix, return_lse=True)
        else:
            out, lse = _fwd_scan(q, k, v, blk)
        ctx.blk = blk
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_scan(q, k, v, out, lse, dout, ctx.blk)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    prefix_len: int = 0, q_chunk: int = 1024, k_chunk: int = 1024):
    """GQA blockwise attention, q [b, s, h, d]; k, v [b, t, g, d].  The
    chunks set the backward's block pairs (and the CPU forward's); the
    kernel tiles for itself."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, sliding_window, prefix_len,
                                    q_chunk, k_chunk)
    return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, sliding_window=sliding_window,
                         prefix_len=prefix_len)
