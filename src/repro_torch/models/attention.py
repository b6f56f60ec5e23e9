"""Attention: GQA + RoPE and paged decode — the port of
``src/repro/models/attention.py`` (single-device paths).

Decode attention goes through the hand-written ``paged_attention`` kernel
(``kernels/paged_attention/ops.py``): on CUDA tensors it launches, on CPU
tensors it runs the plain version.  The ``shard_map`` flash-decoding
branch of ``paged_decode_with_write`` waits for the distribution slice.

Unlike the functional reference, ``write_token_kv`` writes the new
token's K/V into the given pages IN PLACE (one token per sequence, no
copy of the whole cache per layer and step) and returns the same pages.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_prefill.ref import dense_ref
from repro_torch.kernels.paged_attention.ops import paged_attention

__all__ = [
    "rope", "gqa_attention", "paged_decode_attention", "write_token_kv",
    "KVPages", "paged_decode_with_write",
]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Angles in
    f32, output in x.dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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


def write_token_kv(pages: KVPages, k_new, v_new, block_tables, context_lens) -> KVPages:
    """Scatter one new token's K/V ([b, g, d]) into each sequence's current
    page, in place.  ``context_lens`` counts the tokens already present."""
    b = k_new.shape[0]
    bs = pages.block_size
    blk_idx = (context_lens // bs).long()
    blk = torch.gather(block_tables.long(), 1, blk_idx[:, None])[:, 0]
    off = (context_lens % bs).long()
    rows = torch.arange(b, device=k_new.device)
    pages.k_pages[rows, blk, off] = k_new.to(pages.k_pages.dtype)
    pages.v_pages[rows, blk, off] = v_new.to(pages.v_pages.dtype)
    return pages


def paged_decode_attention(q, pages: KVPages, block_tables, context_lens):
    """One new token per sequence over its paged context; ``context_lens``
    counts the tokens INCLUDING the one just written.  Pages of another
    dtype than q (f32 compute over a bf16 cache) are promoted to q's, as
    the reference's einsum promotes them."""
    k_pages, v_pages = pages.k_pages, pages.v_pages
    if k_pages.dtype != q.dtype:
        k_pages, v_pages = k_pages.to(q.dtype), v_pages.to(q.dtype)
    return paged_attention(q.contiguous(), k_pages, v_pages,
                           block_tables.to(torch.int32).contiguous(),
                           context_lens.to(torch.int32).contiguous())


def paged_decode_with_write(q, k_new, v_new, pages: KVPages, block_tables,
                            context_lens) -> tuple[torch.Tensor, KVPages]:
    """Write the new token's KV, then attend over the paged context
    (``context_lens``: tokens BEFORE this step's write)."""
    pages = write_token_kv(pages, k_new, v_new, block_tables, context_lens)
    out = paged_decode_attention(q, pages, block_tables, context_lens + 1)
    return out, pages
