"""RMSNorm, with an optional residual added first: the CUDA kernel
(``csrc/norm_rope_act.cu``, ``rmsnorm_launch``) for CUDA tensors that need
no gradient, the plain version (``ref.py``) on the CPU, on meta tensors
and under autograd.  The kernel takes float32 or bfloat16, x, the scale
and the residual in one dtype; CUDA tensors of other dtypes raise.

Replaces no Pallas kernel: the reference's ``layers.rmsnorm`` is jnp ops
that XLA fuses.  It was added because eager PyTorch runs an RMSNorm as 9
kernels (3 casts, 3 products, a mean, an add, an rsqrt) and a residual add
as one more, each a launch of its own inside a replayed decode graph.
Bound: bytes (x, and the residual, read once, the output and the sum
written once; a Yi-9B decode row moves 16-32 KiB), in practice the launch.
Design: one block a row, 16-byte loads, the f32 sum of squares by warp
shuffles, the plain version's roundings (the ``.cu`` file's note)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref

__all__ = ["rmsnorm", "add_rmsnorm"]


def _launch(name, x, residual, scale, eps):
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for rows of {d}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"{name}: residual {tuple(residual.shape)} for x {tuple(x.shape)}")
    code = build.layer_dtype(name, x, scale, *(() if residual is None else (residual,)))
    x, scale = x.contiguous(), scale.contiguous()
    out = torch.empty_like(x)
    total = None
    if residual is not None:
        residual, total = residual.contiguous(), torch.empty_like(x)
    err = build.library().rmsnorm_launch(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        None if total is None else total.data_ptr(), scale.data_ptr(), out.data_ptr(),
        x.numel() // d if d else 0, d, float(eps), code, build.stream_ptr(x.device))
    build.check(err, name)
    return total, out


def rmsnorm(x, scale, eps: float):
    """x [..., d] normalised over its last dim, times ``scale`` [d], in x's dtype."""
    if not build.no_grad_on_cuda("rmsnorm", x, scale):
        return rmsnorm_ref(x, scale, eps)
    out = _launch("rmsnorm", x, None, scale, eps)[1]
    rmsnorm.launches += 1
    return out


def add_rmsnorm(x, residual, scale, eps: float):
    """(x + residual, its RMSNorm): the add rounded as the plain add rounds,
    in one launch on the card."""
    if not build.no_grad_on_cuda("add_rmsnorm", x, scale, residual):
        return add_rmsnorm_ref(x, residual, scale, eps)
    total, out = _launch("add_rmsnorm", x, residual, scale, eps)
    add_rmsnorm.launches += 1
    return total, out


rmsnorm.launches = 0
add_rmsnorm.launches = 0
