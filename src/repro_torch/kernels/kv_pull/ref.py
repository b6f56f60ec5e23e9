"""Plain PyTorch versions of the kv_pull kernels.  Like the kernels, they
update ``dst`` in place (pages no transaction names keep their bytes) and
return it."""
from __future__ import annotations

import torch

__all__ = ["kv_pull_ref", "kv_pull_runs_ref", "kv_pull_dequant_ref"]


def kv_pull_ref(src_pages, dst_pages, src_ids, dst_ids):
    """dst_pages[dst_ids[i]] = src_pages[src_ids[i]]."""
    dst_pages[dst_ids.long()] = src_pages[src_ids.long()]
    return dst_pages


def kv_pull_runs_ref(src_pages, dst_pages, src_starts, dst_starts, *, run_len: int):
    """Runs of ``run_len`` adjacent pages: dst_pages[d * run_len + j] =
    src_pages[s * run_len + j] for each (s, d) of the starts, which are in
    run units (page_id = start * run_len), and j < run_len."""
    offs = torch.arange(run_len, device=src_starts.device)
    src_ids = (src_starts.long()[:, None] * run_len + offs).reshape(-1)
    dst_ids = (dst_starts.long()[:, None] * run_len + offs).reshape(-1)
    dst_pages[dst_ids] = src_pages[src_ids]
    return dst_pages


def kv_pull_dequant_ref(src_pages, dst_pages, src_ids, dst_ids, scales):
    """int8 pages land dequantized: f32 product with the transaction's
    scale, then one cast to dst's dtype."""
    src = src_pages[src_ids.long()].float()
    deq = src * scales.reshape((-1,) + (1,) * (src.dim() - 1))
    dst_pages[dst_ids.long()] = deq.to(dst_pages.dtype)
    return dst_pages
