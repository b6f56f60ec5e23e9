"""Descriptor-driven KV page pull: the CUDA kernels on CUDA tensors
(``csrc/kv_pull.cu``), the plain versions on CPU tensors.  All three
entry points update ``dst_pages`` in place and return it: ``kv_pull`` (a
page a transaction), ``kv_pull_runs`` (``run_len`` adjacent pages a
transaction, starts in run units, one contiguous copy a run) and
``kv_pull_dequant`` (int8 pages dequantized on the way).  The transfer
engine expands a tick's coalesced runs into page ids for one ``kv_pull``
launch; ``kv_pull_runs`` is the reference's run-granular entry point for
callers that hold whole runs."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.kv_pull.ref import (
    kv_pull_dequant_ref, kv_pull_ref, kv_pull_runs_ref)

__all__ = ["kv_pull", "kv_pull_runs", "kv_pull_dequant", "work"]

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


def work(n_txn: int, src_page_bytes: int, dst_page_bytes: int,
         run_len: int = 1) -> tuple[int, int]:
    """(operations, bytes) of one call of ``n_txn`` transactions of
    ``run_len`` pages each, the bound's formula: each source page read
    once, each destination page written once, a transaction's two ids
    (and a dequant's scale, 4 bytes) read once."""
    return 0, n_txn * (run_len * (src_page_bytes + dst_page_bytes) + 8)


def _meta(name, src_pages, dst_pages, src_ids, scaled=False, run_len=1):
    page = src_pages[0].numel() if len(src_pages) else 0
    flops, nbytes = work(src_ids.shape[0], page * src_pages.element_size(),
                         page * dst_pages.element_size(), run_len)
    build.count_meta(name, flops, nbytes + (4 * src_ids.shape[0] if scaled else 0))
    return dst_pages


def _page_bytes(pages) -> int:
    return pages[0].numel() * pages.element_size() if len(pages) else 0


def kv_pull(src_pages, dst_pages, src_ids, dst_ids):
    """dst_pages[dst_ids[i]] = src_pages[src_ids[i]]; pages of any dtype."""
    _check_pages("kv_pull", src_pages, dst_pages, src_ids, dst_ids)
    if build.on_meta("kv_pull", src_pages, dst_pages, src_ids, dst_ids):
        return _meta("kv_pull", src_pages, dst_pages, src_ids)
    if not build.on_cuda("kv_pull", src_pages, dst_pages, src_ids, dst_ids):
        return kv_pull_ref(src_pages, dst_pages, src_ids, dst_ids)
    for t in (src_pages, dst_pages, src_ids, dst_ids):
        if not t.is_contiguous():
            raise ValueError("kv_pull: inputs must be contiguous")
    if src_pages.dtype != dst_pages.dtype:
        raise TypeError("kv_pull: src and dst pages must share a dtype")
    if src_ids.shape[0] == 0:
        return dst_pages  # nothing to move: no launch
    err = build.library().kv_pull_launch(
        src_pages.data_ptr(), dst_pages.data_ptr(), src_ids.data_ptr(),
        dst_ids.data_ptr(), src_ids.shape[0], _page_bytes(src_pages),
        build.stream_ptr(dst_pages.device))
    build.check(err, "kv_pull")
    kv_pull.launches += 1
    return dst_pages


def _check_runs(src_pages, dst_pages, src_starts, dst_starts, run_len):
    """Raise unless every run lies inside both pools.  On the card this
    reads the starts' extremes to the host (one synchronisation); under
    CUDA-graph capture, where no synchronisation may run, the check is
    left to the eager calls that precede a capture."""
    if src_starts.shape[0] == 0:
        return
    if src_starts.is_cuda and torch.cuda.is_current_stream_capturing():
        return
    lo_s, hi_s, lo_d, hi_d = torch.stack([src_starts.min(), src_starts.max(),
                                          dst_starts.min(), dst_starts.max()]).tolist()
    if min(lo_s, lo_d) < 0 or (hi_s + 1) * run_len > src_pages.shape[0] \
            or (hi_d + 1) * run_len > dst_pages.shape[0]:
        raise IndexError(f"kv_pull_runs: runs of {run_len} pages from starts "
                         f"[{lo_s}, {hi_s}] -> [{lo_d}, {hi_d}] leave pools of "
                         f"{src_pages.shape[0]} -> {dst_pages.shape[0]} pages")


def kv_pull_runs(src_pages, dst_pages, src_starts, dst_starts, *, run_len: int):
    """dst_pages[d * run_len + j] = src_pages[s * run_len + j] for each run
    (s, d) of the starts (in run units, page_id = start * run_len) and
    j < run_len; pages of any dtype.  On the card, one transaction a run:
    ``run_len`` x page bytes contiguous from byte ``start * run_len *
    page_bytes``."""
    _check_pages("kv_pull_runs", src_pages, dst_pages, src_starts, dst_starts)
    if not isinstance(run_len, int) or run_len < 1:
        raise ValueError(f"kv_pull_runs: run_len must be a positive int, got {run_len!r}")
    if build.on_meta("kv_pull_runs", src_pages, dst_pages, src_starts, dst_starts):
        return _meta("kv_pull_runs", src_pages, dst_pages, src_starts, run_len=run_len)
    on_card = build.on_cuda("kv_pull_runs", src_pages, dst_pages, src_starts, dst_starts)
    if on_card:
        for t in (src_pages, dst_pages, src_starts, dst_starts):
            if not t.is_contiguous():
                raise ValueError("kv_pull_runs: inputs must be contiguous")
    if src_pages.dtype != dst_pages.dtype:
        raise TypeError("kv_pull_runs: src and dst pages must share a dtype")
    _check_runs(src_pages, dst_pages, src_starts, dst_starts, run_len)
    if not on_card:
        return kv_pull_runs_ref(src_pages, dst_pages, src_starts, dst_starts,
                                run_len=run_len)
    if src_starts.shape[0] == 0:
        return dst_pages  # nothing to move: no launch
    err = build.library().kv_pull_runs_launch(
        src_pages.data_ptr(), dst_pages.data_ptr(), src_starts.data_ptr(),
        dst_starts.data_ptr(), src_starts.shape[0], _page_bytes(src_pages), run_len,
        build.stream_ptr(dst_pages.device))
    build.check(err, "kv_pull_runs")
    kv_pull_runs.launches += 1
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
    if build.on_meta("kv_pull_dequant", src_pages, dst_pages, src_ids, dst_ids, scales):
        return _meta("kv_pull_dequant", src_pages, dst_pages, src_ids, scaled=True)
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
kv_pull_runs.launches = 0
kv_pull_dequant.launches = 0
