"""Plain PyTorch version of the paged_attention kernel: gather each
sequence's pages through its block table, then dense attention of the
one new token over the first ``context_lens`` positions (the contract of
``repro.models.attention.paged_decode_attention``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_prefill.ref import dense_ref

__all__ = ["paged_attention_ref"]


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens):
    """q [b, h, d]; pages [b, per_seq, bs, g, d]; block_tables [b, per_seq];
    context_lens [b] counting the current token -> [b, h, d]."""
    b, h, d = q.shape
    _, _, bs, g, _ = k_pages.shape
    mb = block_tables.shape[1]
    idx = block_tables.long()[:, :, None, None, None].expand(b, mb, bs, g, d)
    k = torch.gather(k_pages, 1, idx).reshape(b, mb * bs, g, d)
    v = torch.gather(v_pages, 1, idx).reshape(b, mb * bs, g, d)
    out = dense_ref(q[:, None], k, v, causal=True,
                    q_offset=context_lens - 1, kv_len=context_lens)
    return out[:, 0]
