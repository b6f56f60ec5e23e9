"""Blockwise prefill attention: the CUDA kernels on CUDA tensors
(``csrc/flash_prefill.cu``: bf16 on the tensor cores, f32 with scalar
FMA), the plain version on CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ref import dense_ref

__all__ = ["flash_prefill", "k_tiles"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BF16_HEAD_DIMS = (32, 64, 128)
# The kernels' tiles as ``k_tiles`` models them, and the f32 kernel's widest
# head; ``flash_prefill_design`` in the compiled kernels must report the
# same before the first launch.
F32_TILE = 32                # q and k rows of an f32 tile
BF16_TILE = 64               # q and k rows of a bf16 tile
MAX_HEAD_DIM = 128           # the f32 kernel's
DESIGN = {"f32_q_tile": F32_TILE, "f32_k_tile": F32_TILE, "bf16_tile": BF16_TILE,
          "f32_max_head_dim": MAX_HEAD_DIM}


def k_tiles(q_lo: int, s: int, t: int, tile: int, *, causal: bool, window: int = 0,
            prefix: int = 0) -> list[int]:
    """The k tiles a kernel's q tile starting at row ``q_lo`` visits, in
    order: every tile of ``tile`` keys below t, up to the causal limit of
    its last row below s, less the tiles the window hides wholly
    (``models.flash.pair_schedule``'s block rule: a tile is kept when any
    key of it lies in the window of row q_lo or below the prefix).  The
    bf16 kernel walks [0, n_pref) then [j0, n_kt) exactly so."""
    n_kt = -(-t // tile)
    if causal:
        n_kt = min(n_kt, (min(q_lo + tile, s) - 1) // tile + 1)
    n_pref = j0 = 0
    if window:
        n_pref = -(-prefix // tile) if prefix > 0 else 0
        x = q_lo - window - tile + 1  # tiles j <= x // tile lie fully out
        j0 = x // tile + 1 if x >= 0 else 0
    return [j for j in range(n_kt) if j < n_pref or j >= j0]


def flash_prefill(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                  prefix_len: int = 0, return_lse: bool = False):
    """q [b, s, h, d]; k, v [b, t, g, d] -> [b, s, h, d] in q.dtype.  Any
    s and t: ragged edges are masked inside the kernel.  ``return_lse``
    returns (out, lse [b, h, s] f32) instead, lse being each row's
    log-sum-exp of its scaled scores (-inf for a row that sees no key),
    which the training path's backward recomputes the softmax from."""
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
                         prefix_len=prefix_len, return_lse=return_lse)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill: inputs must be contiguous")
    if q.dtype == torch.bfloat16:
        if d not in BF16_HEAD_DIMS:
            raise ValueError(f"flash_prefill: bf16 head_dim {d} not in {BF16_HEAD_DIMS}")
        if any(x.data_ptr() % 16 for x in (q, k, v)):
            raise ValueError("flash_prefill: bf16 inputs must be 16-byte aligned")
    elif d > MAX_HEAD_DIM:
        raise ValueError(f"flash_prefill: head_dim {d} > {MAX_HEAD_DIM}")
    lib = build.library()
    build.check_design("flash_prefill", DESIGN, lib)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if return_lse else None, b, s, t, h, g, d,
        int(causal), int(sliding_window), int(prefix_len), float(d) ** -0.5,
        _DTYPES[q.dtype], build.stream_ptr(q.device))
    build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return (out, lse) if return_lse else out


flash_prefill.launches = 0
