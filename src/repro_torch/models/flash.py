"""Blockwise (flash) attention, forward only — the port of
``src/repro/models/flash.py``.

The forward runs the hand-written ``flash_prefill`` kernel
(``kernels/flash_prefill/ops.py``), which masks ragged lengths itself, so
there is no chunk-alignment requirement and no chunk argument.  The
custom-VJP backward (``flash.py:121-195``) waits for the training slice.
``pair_schedule`` is this package's own copy of ``flash.py:32-59``: the
block-level visibility rule the kernel applies to skip fully masked
k tiles.
"""
from __future__ import annotations

from repro_torch.kernels.flash_prefill.ops import flash_prefill

__all__ = ["flash_attention", "pair_schedule"]


def pair_schedule(
    s: int, t: int, q_chunk: int, k_chunk: int,
    *, causal: bool, window: int = 0, prefix: int = 0, q_offset: int = 0,
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Static (i, j) block pairs that contain ≥1 visible (q, k) position.

    q position of chunk i spans [q_offset + i·cq, q_offset + (i+1)·cq);
    k position of chunk j spans [j·ck, (j+1)·ck).  Visibility:
    k ≤ q (causal) ∧ (k > q − window ∨ k < prefix) (sliding window).
    """
    pi, pj = [], []
    nq, nk = s // q_chunk, t // k_chunk
    for i in range(nq):
        q_lo = q_offset + i * q_chunk
        q_hi = q_lo + q_chunk - 1
        for j in range(nk):
            k_lo = j * k_chunk
            k_hi = k_lo + k_chunk - 1
            if causal and k_lo > q_hi:
                continue  # fully in the future
            if window:
                fully_out = k_hi <= q_lo - window
                covers_prefix = prefix > 0 and k_lo < prefix
                if fully_out and not covers_prefix:
                    continue
            pi.append(i)
            pj.append(j)
    return tuple(pi), tuple(pj)


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: int = 0,
                    prefix_len: int = 0):
    """GQA blockwise attention, q [b, s, h, d]; k, v [b, t, g, d]."""
    return flash_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, sliding_window=sliding_window,
                         prefix_len=prefix_len)
