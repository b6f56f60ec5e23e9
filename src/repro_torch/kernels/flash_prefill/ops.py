"""Blockwise prefill attention: the CUDA kernel on CUDA tensors
(``csrc/flash_prefill.cu``), the plain version on CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ref import dense_ref

__all__ = ["flash_prefill"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def flash_prefill(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                  prefix_len: int = 0):
    """q [b, s, h, d]; k, v [b, t, g, d] -> [b, s, h, d] in q.dtype.  Any
    s and t: ragged edges are masked inside the kernel."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill: q [b,s,h,d], k/v [b,t,g,d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % g:
        raise ValueError("flash_prefill: k/v do not match q (batch, head_dim or groups)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill: q, k, v must share f32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not build.on_cuda("flash_prefill", q, k, v):
        return dense_ref(q, k, v, causal=causal, sliding_window=sliding_window,
                         prefix_len=prefix_len)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_prefill: head_dim {d} > {MAX_HEAD_DIM}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill: inputs must be contiguous")
    out = torch.empty_like(q)
    err = build.library().flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t, h, g, d,
        int(causal), int(sliding_window), int(prefix_len), float(d) ** -0.5,
        _DTYPES[q.dtype], build.stream_ptr(q.device))
    build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
