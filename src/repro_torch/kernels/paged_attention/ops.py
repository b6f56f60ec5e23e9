"""Paged decode attention: the CUDA kernel on CUDA tensors
(``csrc/paged_attention.cu``), the plain version on CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _validate(q, k_pages, v_pages, block_tables, context_lens):
    if q.dim() != 3 or k_pages.dim() != 5:
        raise ValueError(f"paged_attention: q [b,h,d] and pages [b,per_seq,bs,g,d], "
                         f"got {tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, h, d = q.shape
    _, per_seq, bs, g, _ = k_pages.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[0] != b or k_pages.shape[4] != d:
        raise ValueError("paged_attention: page shapes do not match q")
    if h % g:
        raise ValueError(f"paged_attention: {h} heads not a multiple of {g} kv-heads")
    if tuple(block_tables.shape) != (b, per_seq) or tuple(context_lens.shape) != (b,):
        raise ValueError("paged_attention: block_tables [b, per_seq], context_lens [b]")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_attention: q and pages must share f32 or bf16, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_tables and context_lens must be int32")


def paged_attention(q, k_pages, v_pages, block_tables, context_lens):
    """q [b, h, d]; k/v pages [b, per_seq, bs, g, d]; block_tables
    [b, per_seq] int32 (within-sequence page ids); context_lens [b] int32,
    counting the current token -> [b, h, d] in q.dtype."""
    _validate(q, k_pages, v_pages, block_tables, context_lens)
    if not build.on_cuda("paged_attention", q, k_pages, v_pages, block_tables,
                         context_lens):
        return paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens)
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    b, h, d = q.shape
    _, per_seq, bs, g, _ = k_pages.shape
    out = torch.empty_like(q)
    err = build.library().paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), b, h, g, d, per_seq, bs,
        float(d) ** -0.5, _DTYPES[q.dtype], build.stream_ptr(q.device))
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
