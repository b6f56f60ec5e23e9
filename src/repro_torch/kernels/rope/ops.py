"""Rotate-half RoPE of q and k in one launch: the CUDA kernel
(``csrc/norm_rope_act.cu``, ``rope_launch``) for CUDA tensors that need no
gradient, the plain version (``ref.py``) on the CPU, on meta tensors and
under autograd.  The kernel takes float32 or bfloat16 q and k in one
dtype and int32 or int64 positions; CUDA tensors of other dtypes raise.

Replaces no Pallas kernel: the reference's ``attention.rope`` is jnp ops
that XLA fuses.  It was added because eager PyTorch runs a RoPE call as
about 16 kernels (the frequencies, the angles, cos, sin, four products, a
sum, a difference, a concatenation and casts), twice a layer, each a
launch of its own inside a replayed decode graph.  Bound: bytes (q and k
read and written once; a Yi-9B decode token moves 18 KiB), in practice
the launch.  Design: a (head, frequency) pair a thread over q's heads,
then k's, a token's pairs over a row of blocks; the
frequencies one f32 tensor cached per (theta, head size, device), made
by the plain version's own expression, so that the angles are bit for bit
the plain version's; accurate ``sincosf`` (the ``.cu`` file's note)."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rope.ref import rope_freqs, rope_ref

__all__ = ["rope"]


@functools.lru_cache(maxsize=None)
def _freqs(theta: float, hd: int, device: torch.device) -> torch.Tensor:
    return rope_freqs(theta, hd, device)


def rope(q, k, positions, theta: float):
    """(q, k) rotated by their positions: q [..., seq, h, hd], k [..., seq,
    g, hd] and positions broadcasting to [..., seq].  Angles in f32,
    outputs in the inputs' dtype."""
    if not build.no_grad_on_cuda("rope", q, k, positions):
        return rope_ref(q, positions, theta), rope_ref(k, positions, theta)
    lead, hd = q.shape[:-2], q.shape[-1]
    if hd % 2 or not lead or k.shape[:-2] != lead or k.shape[-1] != hd:
        raise ValueError(f"rope: q {tuple(q.shape)} and k {tuple(k.shape)} do not pair")
    if positions.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rope: positions of {positions.dtype}, the kernel takes int32 or int64")
    code = build.layer_dtype("rope", q, k)
    # the positions of the tokens in order, as [outer, lead[-1]] strides (a
    # broadcast read in place)
    pos = positions.expand(lead).reshape(-1, lead[-1])
    q, k = q.contiguous(), k.contiguous()
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    err = build.library().rope_launch(
        q.data_ptr(), k.data_ptr(), q_out.data_ptr(), k_out.data_ptr(), pos.data_ptr(),
        int(pos.dtype == torch.int64), pos.numel(), lead[-1], pos.stride(0), pos.stride(1),
        _freqs(float(theta), hd, q.device).data_ptr(), q.shape[-2], k.shape[-2], hd, code,
        build.stream_ptr(q.device))
    build.check(err, "rope")
    rope.launches += 1
    return q_out, k_out


rope.launches = 0
