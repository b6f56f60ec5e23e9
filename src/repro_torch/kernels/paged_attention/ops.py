"""Paged decode attention: the CUDA kernel on CUDA tensors
(``csrc/paged_attention.cu``, split over the context: one block per
kv-head, sequence and partition of pages, then a combine), the plain
version on CPU tensors.  ``return_lse`` adds each head's log-sum-exp of
its scaled scores (f32 [b, h], natural log; -inf and a zero output for a
context of 0), which a sequence-parallel decode combines across ranks
with (``models/attention.py``)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention", "partitions"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's d: 8 elements per lane, d / 8 lanes per key
# The kernel's design as this module models it; ``paged_attention_design``
# in the compiled kernel must report the same before the first launch.
THREADS = 128                # per block; 128 / (d / 8) streams of lanes per block
HEADS_PER_BLOCK = 8          # query heads sharing a block's K/V loads
KEY_BATCH = {torch.float32: 2, torch.bfloat16: 4}  # keys a stream loads at once
MAX_PART_PAGES = 1024        # pages per partition (the kernel copies their table entries)
WRITES_LSE = 1               # the launch takes an lse output
DESIGN = {"threads": THREADS, "heads_per_block": HEADS_PER_BLOCK,
          "key_batch_f32": KEY_BATCH[torch.float32],
          "key_batch_bf16": KEY_BATCH[torch.bfloat16], "max_part_pages": MAX_PART_PAGES,
          "writes_lse": WRITES_LSE}
BLOCKS_PER_SM = 4            # the grid the partition size aims at


def partitions(b: int, g: int, qpg: int, per_seq: int, sm_count: int) -> tuple[int, int]:
    """(pages per partition, partitions per sequence) of the split-KV grid
    (g x ceil(qpg / 8), b, partitions): the fewest pages per partition
    that keep the grid within about BLOCKS_PER_SM blocks per SM, at most
    MAX_PART_PAGES.  The contexts are on the card, so the choice reads
    only the page count."""
    head_blocks = g * -(-qpg // HEADS_PER_BLOCK)
    want = max(1, -(-BLOCKS_PER_SM * sm_count // (b * head_blocks)))
    pages = min(-(-per_seq // min(per_seq, want)), MAX_PART_PAGES)
    return pages, -(-per_seq // pages)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def paged_attention(q, k_pages, v_pages, block_tables, context_lens, *,
                    return_lse: bool = False):
    """q [b, h, d]; k/v pages [b, per_seq, bs, g, d]; block_tables
    [b, per_seq] int32 (within-sequence page ids); context_lens [b] int32,
    counting the current token -> [b, h, d] in q.dtype, and with
    ``return_lse`` (out, lse [b, h] f32)."""
    _validate(q, k_pages, v_pages, block_tables, context_lens)
    if not build.on_cuda("paged_attention", q, k_pages, v_pages, block_tables,
                         context_lens):
        return paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                                   return_lse=return_lse)
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: inputs must be contiguous")
    b, h, d = q.shape
    _, per_seq, bs, g, _ = k_pages.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {d} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q and pages must be 16-byte aligned")
    lib = build.library()
    build.check_design("paged_attention", DESIGN, lib)
    pages, n_part = partitions(b, g, h // g, per_seq, _sm_count(q.device.index))
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if return_lse else None
    ml = acc = None
    if n_part > 1:  # the partials: (m, l) [b, h, n_part, 2], then acc [b, h, n_part, d]
        scratch = torch.empty(b * h * n_part * (2 + d), dtype=torch.float32, device=q.device)
        ml = scratch.data_ptr()
        acc = ml + b * h * n_part * 2 * 4
    grid = (ctypes.c_int * 3)()
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        context_lens.data_ptr(), out.data_ptr(), lse.data_ptr() if return_lse else None, ml,
        acc, b, h, g, d, per_seq, bs, pages,
        n_part, float(d) ** -0.5, _DTYPES[q.dtype], grid, build.stream_ptr(q.device))
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.launches_lse += int(return_lse)
    paged_attention.last_grid = tuple(grid)
    return (out, lse) if return_lse else out


paged_attention.launches = 0
paged_attention.launches_lse = 0  # of those, the launches that wrote lse
paged_attention.last_grid = None  # the split kernel's grid at the last launch, as launched
