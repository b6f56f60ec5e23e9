"""Attention: GQA + RoPE and paged decode — the port of
``src/repro/models/attention.py``.

Decode attention goes through the hand-written ``paged_attention`` kernel
(``kernels/paged_attention/ops.py``): on CUDA tensors it launches, on CPU
tensors it runs the plain version.  Under a mesh with the pages split over
'model' (``seq_parallel``), ``paged_decode_with_write`` is the reference's
``shard_map`` flash-decoding branch (``attention.py:230-301``): each rank
runs the kernel over its slice of every sequence's pages, with its
log-sum-exp, and the partial results combine across ranks.

Unlike the functional reference, ``write_token_kv`` writes the new
token's K/V into the given pages IN PLACE (one token per sequence, no
copy of the whole cache per layer and step) and returns the same pages.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_prefill.ref import dense_ref
from repro_torch.kernels.paged_attention.ops import paged_attention
# rope_qk: q and k rotated together (one launch on the card); rope: the
# plain rotate-half of one tensor
from repro_torch.kernels.rope.ops import rope as rope_qk
from repro_torch.kernels.rope.ref import rope_ref as rope
from repro_torch.models import sharding

__all__ = [
    "rope", "rope_qk", "gqa_attention", "paged_decode_attention", "token_slots", "write_token_kv",
    "KVPages", "paged_decode_with_write",
]


def gqa_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                  q_offset=0, kv_len=None, prefix_len: int = 0):
    """q [b, s, h, d]; k, v [b, t, g, d] -> [b, s, h, d].  Fully masked
    rows give 0, not NaN."""
    return dense_ref(q, k, v, causal=causal, sliding_window=sliding_window,
                     prefix_len=prefix_len, q_offset=q_offset, kv_len=kv_len)


@dataclasses.dataclass
class KVPages:
    """Paged KV for ONE layer: k_pages / v_pages [batch, pages_per_seq,
    block_size, kv_heads, head_dim], per-sequence page pools."""

    k_pages: torch.Tensor
    v_pages: torch.Tensor

    @property
    def block_size(self) -> int:
        return self.k_pages.shape[2]


def token_slots(block_tables, context_lens, block_size: int) -> torch.Tensor:
    """Where each sequence's next token goes: its row in a layer's pages
    [b, per_seq, block_size, ...] flattened over the first three dims,
    int64 [b].  ``context_lens`` counts the tokens already present."""
    b, per_seq = block_tables.shape
    blk = torch.gather(block_tables.long(), 1, (context_lens // block_size).long()[:, None])[:, 0]
    rows = torch.arange(b, device=block_tables.device)
    return (rows * per_seq + blk) * block_size + (context_lens % block_size).long()


def write_token_kv(pages: KVPages, k_new, v_new, block_tables, context_lens,
                   slots=None) -> KVPages:
    """Scatter one new token's K/V ([b, g, d]) into each sequence's current
    page, in place.  ``context_lens`` counts the tokens already present;
    ``slots``: their ``token_slots``, when the caller has them."""
    if slots is None:
        slots = token_slots(block_tables, context_lens, pages.block_size)
    for plane, new in ((pages.k_pages, k_new), (pages.v_pages, v_new)):
        plane.view(-1, *plane.shape[3:]).index_copy_(0, slots, new.to(plane.dtype))
    return pages


def paged_decode_attention(q, pages: KVPages, block_tables, context_lens, *,
                           return_lse: bool = False, out=None):
    """One new token per sequence over its paged context; ``context_lens``
    counts the tokens INCLUDING the one just written.  Pages of another
    dtype than q (f32 compute over a bf16 cache) are promoted to q's, as
    the reference's einsum promotes them.  ``out``: where to write the
    output (the kernel's ``out``)."""
    k_pages, v_pages = pages.k_pages, pages.v_pages
    if k_pages.dtype != q.dtype:
        k_pages, v_pages = k_pages.to(q.dtype), v_pages.to(q.dtype)
    return paged_attention(q.contiguous(), k_pages, v_pages,
                           block_tables.to(torch.int32).contiguous(),
                           context_lens.to(torch.int32).contiguous(), return_lse=return_lse,
                           out=out)


def identity_slice(b: int, pages_per_rank: int, device) -> torch.Tensor:
    """The block tables of this rank's slice under the identity layout:
    rank i owns the pages [i·pps, (i+1)·pps) of every sequence."""
    lo = sharding.axis_index("model") * pages_per_rank
    return torch.arange(lo, lo + pages_per_rank, dtype=torch.int32,
                        device=device)[None].repeat(b, 1)


def paged_decode_with_write(q, k_new, v_new, pages: KVPages, block_tables, context_lens, *,
                            seq_parallel: bool = False) -> tuple[torch.Tensor, KVPages]:
    """Write the new token's KV, then attend over the paged context
    (``context_lens``: tokens BEFORE this step's write).

    ``seq_parallel`` (under a mesh whose 'model' axis splits every
    sequence's pages, ``pages`` and ``block_tables`` this rank's slice of
    the identity layout, which the caller has checked): q [b, h, d] and
    k_new / v_new [b, g, d] hold every head and group.  Rank i writes the
    new token only where it owns the page, runs the kernel over its slice
    (local tables ``arange(pps)``, local context ``clamp(cl + 1 - i·pps·bs,
    0, pps·bs)``: 0 on a rank past the context, which gives out 0 and
    lse -inf), then M = max over ranks of lse, w = exp(lse - M), and the
    sums over ranks of out·w and w (one f32 all-reduce of [b, h, d + 1])
    give the output: 2·b·h·4 + b·h·d·4 bytes, the reference's psums'."""
    if not seq_parallel:
        pages = write_token_kv(pages, k_new, v_new, block_tables, context_lens)
        out = paged_decode_attention(q, pages, block_tables, context_lens + 1)
        return out, pages

    b, h, d = q.shape
    _, pps, bs, _, _ = pages.k_pages.shape
    first = sharding.axis_index("model") * pps * bs    # this slice's first token
    # ownership-masked write of the new token (no host sync)
    rows = torch.arange(b, device=q.device)
    blk = (context_lens.long() - first) // bs
    own = (blk >= 0) & (blk < pps)
    blk = blk.clamp(0, pps - 1)
    off = (context_lens % bs).long()
    for plane, new in ((pages.k_pages, k_new), (pages.v_pages, v_new)):
        cur = plane[rows, blk, off]
        plane[rows, blk, off] = torch.where(own[:, None, None], new.to(plane.dtype), cur)

    local_ctx = (context_lens.long() + 1 - first).clamp(0, pps * bs)
    tables = torch.arange(pps, dtype=torch.int32, device=q.device)[None].repeat(b, 1)
    out, lse = paged_decode_attention(q, pages, tables, local_ctx, return_lse=True)
    m = sharding.all_reduce(lse, "model", op="max")
    w = torch.exp(lse - m)                                      # [b, h]; 0 for an empty slice
    part = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    tot = sharding.all_reduce(part, "model")
    return (tot[..., :d] / tot[..., d:]).to(q.dtype), pages
