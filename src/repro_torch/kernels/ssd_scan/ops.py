"""Mamba-2 SSD chunked scan: the CUDA kernels on CUDA tensors
(``csrc/ssd_scan.cu``: C.B^T per chunk beside each chunk's decay cumsum
and own state, then the state passing, then the outputs; three launches
of one C entry, one count), the plain version on CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

__all__ = ["ssd_scan", "KERNEL_CHUNK", "HD_TILE", "THREADS", "DESIGN", "chunking"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's design as this module models it; ``ssd_scan_design`` in the
# compiled kernel must report the same before the first launch.
KERNEL_CHUNK = 64  # the longest internal chunk: the rows of every tile (and of the CB scratch)
HD_TILE = 64       # hd columns a block of the chunk-state and output steps
THREADS = 128      # 4 warps a block, one 16-row tensor-core tile each
DESIGN = {"kernel_chunk": KERNEL_CHUNK, "hd_tile": HD_TILE, "threads": THREADS}


def chunking(s: int, chunk: int) -> tuple[int, int]:
    """(internal chunk l, chunks nc) the kernel scans ``s`` rows in."""
    l = min(s, chunk, KERNEL_CHUNK)
    return l, -(-s // l)


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
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    if not build.on_cuda("ssd_scan", x, dt, a, B, C, d_skip):
        return ssd_scan_ref(x, dt, a, B, C, d_skip, chunk=chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, B, C, d_skip)):
        # the kernel has no backward: its output would silently cut the graph
        raise RuntimeError("ssd_scan: the CUDA kernel has no backward; SSM and hybrid "
                           "training on the card is not supported yet (inputs require grad)")
    for t in (x, dt, a, B, C, d_skip):
        if not t.is_contiguous():
            raise ValueError("ssd_scan: inputs must be contiguous")
    b, s, nh, hd = x.shape
    ns = B.shape[-1]
    lib = build.library()
    build.check_design("ssd_scan", DESIGN, lib)
    y = torch.empty_like(x)
    state = torch.empty((b, nh, hd, ns), dtype=torch.float32, device=x.device)
    # scratch: CB [b, nc, K, K], cum [b, nc, nh, K], states [b, nc, nh, hd, ns]
    nc = chunking(s, chunk)[1] if s else 0
    n_cb, n_cum = b * nc * KERNEL_CHUNK ** 2, b * nc * nh * KERNEL_CHUNK
    scratch = torch.empty(n_cb + n_cum + b * nc * nh * hd * ns, dtype=torch.float32,
                          device=x.device)
    cb = scratch.data_ptr()
    err = lib.ssd_scan_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
        d_skip.data_ptr(), y.data_ptr(), state.data_ptr(), cb, cb + 4 * n_cb,
        cb + 4 * (n_cb + n_cum), b, s, nh, hd, ns, min(chunk, KERNEL_CHUNK),
        _DTYPES[x.dtype], build.stream_ptr(x.device))
    build.check(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
