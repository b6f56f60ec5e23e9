"""Mamba-2 SSD chunked scan: the CUDA kernel on CUDA tensors
(``csrc/ssd_scan.cu``), the plain version on CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["ssd_scan", "KERNEL_CHUNK"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_CHUNK = 64  # the kernel's longest internal chunk (csrc/ssd_scan.cu, kMaxL)


def _validate(x, dt, a, B, C, d_skip):
    if x.dim() != 4 or dt.dim() != 3 or B.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"ssd_scan: x [b,s,nh,hd], dt [b,s,nh], B/C [b,s,ns], got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, nh, _ = x.shape
    if dt.shape != (b, s, nh) or B.shape[:2] != (b, s):
        raise ValueError("ssd_scan: dt/B/C do not match x's batch and length")
    if a.shape != (nh,) or d_skip.shape != (nh,):
        raise ValueError(f"ssd_scan: a and d_skip must be [{nh}]")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: x must be f32 or bf16, got {x.dtype}")
    for name, t in (("dt", dt), ("a", a), ("B", B), ("C", C), ("d_skip", d_skip)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} must be f32, got {t.dtype}")


def ssd_scan(x, dt, a, B, C, d_skip, *, chunk: int = 128):
    """x [b, s, nh, hd]; dt [b, s, nh] (post-softplus); a [nh] (negative);
    B, C [b, s, ns]; d_skip [nh] -> (y [b, s, nh, hd] in x.dtype with the
    D term, final state [b, nh, hd, ns] f32).  Any s: rows past the end
    count as dt = 0, x = 0.  ``chunk`` is the plain version's chunk; the
    kernel scans in chunks of min(chunk, KERNEL_CHUNK) (the SSD result
    does not depend on it, only the order of the sums does)."""
    _validate(x, dt, a, B, C, d_skip)
    if not build.on_cuda("ssd_scan", x, dt, a, B, C, d_skip):
        return ssd_scan_ref(x, dt, a, B, C, d_skip, chunk=chunk)
    for t in (x, dt, a, B, C, d_skip):
        if not t.is_contiguous():
            raise ValueError("ssd_scan: inputs must be contiguous")
    b, s, nh, hd = x.shape
    ns = B.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((b, nh, hd, ns), dtype=torch.float32, device=x.device)
    err = build.library().ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        d_skip.data_ptr(), y.data_ptr(), state.data_ptr(), b, s, nh, hd, ns,
        min(chunk, KERNEL_CHUNK), _DTYPES[x.dtype], build.stream_ptr(x.device))
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
