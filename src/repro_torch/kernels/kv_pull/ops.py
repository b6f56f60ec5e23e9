"""Descriptor-driven KV page pull: the CUDA kernels on CUDA tensors
(``csrc/kv_pull.cu``), the plain versions on CPU tensors.  Both update
``dst_pages`` in place and return it.  The reference's ``kv_pull_runs``
(``run_len`` adjacent pages per transaction) needs no wrapper of its own:
the transfer engine expands every coalesced run into page ids, so one
``kv_pull`` launch moves the runs of a whole tick."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_pull.ref import kv_pull_dequant_ref, kv_pull_ref

__all__ = ["kv_pull", "kv_pull_dequant"]

_DST_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_pages(name, src_pages, dst_pages, src_ids, dst_ids):
    if src_pages.dim() < 1 or dst_pages.dim() < 1 \
            or src_pages.shape[1:] != dst_pages.shape[1:]:
        raise ValueError(f"{name}: src/dst pages must be [n, ...] with one page "
                         f"shape, got {tuple(src_pages.shape)}, {tuple(dst_pages.shape)}")
    if src_ids.dim() != 1 or src_ids.shape != dst_ids.shape:
        raise ValueError(f"{name}: ids must be two [n_txn] vectors")
    if src_ids.dtype != torch.int32 or dst_ids.dtype != torch.int32:
        raise TypeError(f"{name}: ids must be int32")


def kv_pull(src_pages, dst_pages, src_ids, dst_ids):
    """dst_pages[dst_ids[i]] = src_pages[src_ids[i]]; pages of any dtype."""
    _check_pages("kv_pull", src_pages, dst_pages, src_ids, dst_ids)
    if not build.on_cuda("kv_pull", src_pages, dst_pages, src_ids, dst_ids):
        return kv_pull_ref(src_pages, dst_pages, src_ids, dst_ids)
    for t in (src_pages, dst_pages, src_ids, dst_ids):
        if not t.is_contiguous():
            raise ValueError("kv_pull: inputs must be contiguous")
    if src_pages.dtype != dst_pages.dtype:
        raise TypeError("kv_pull: src and dst pages must share a dtype")
    if src_ids.shape[0] == 0:
        return dst_pages  # nothing to move: no launch
    page_bytes = src_pages[0].numel() * src_pages.element_size() if len(src_pages) else 0
    err = build.library().kv_pull_launch(
        src_pages.data_ptr(), dst_pages.data_ptr(), src_ids.data_ptr(),
        dst_ids.data_ptr(), src_ids.shape[0], page_bytes,
        build.stream_ptr(dst_pages.device))
    build.check(err, "kv_pull")
    kv_pull.launches += 1
    return dst_pages


def kv_pull_dequant(src_pages, dst_pages, src_ids, dst_ids, scales):
    """dst_pages[dst_ids[i]] = (f32(src_pages[src_ids[i]]) * scales[i]) cast
    to dst's dtype; src int8, dst f32 or bf16, scales [n_txn] f32."""
    _check_pages("kv_pull_dequant", src_pages, dst_pages, src_ids, dst_ids)
    if src_pages.dtype != torch.int8 or dst_pages.dtype not in _DST_DTYPES:
        raise TypeError(f"kv_pull_dequant: int8 -> f32/bf16, got "
                        f"{src_pages.dtype} -> {dst_pages.dtype}")
    if scales.dtype != torch.float32 or scales.shape != src_ids.shape:
        raise TypeError("kv_pull_dequant: scales must be f32 [n_txn]")
    if not build.on_cuda("kv_pull_dequant", src_pages, dst_pages, src_ids, dst_ids,
                         scales):
        return kv_pull_dequant_ref(src_pages, dst_pages, src_ids, dst_ids, scales)
    for t in (src_pages, dst_pages, src_ids, dst_ids, scales):
        if not t.is_contiguous():
            raise ValueError("kv_pull_dequant: inputs must be contiguous")
    if src_ids.shape[0] == 0:
        return dst_pages  # nothing to move: no launch
    page_elems = src_pages[0].numel() if len(src_pages) else 0
    err = build.library().kv_pull_dequant_launch(
        src_pages.data_ptr(), dst_pages.data_ptr(), src_ids.data_ptr(),
        dst_ids.data_ptr(), scales.data_ptr(), src_ids.shape[0], page_elems,
        _DST_DTYPES[dst_pages.dtype], build.stream_ptr(dst_pages.device))
    build.check(err, "kv_pull_dequant")
    kv_pull_dequant.launches += 1
    return dst_pages


kv_pull.launches = 0
kv_pull_dequant.launches = 0
