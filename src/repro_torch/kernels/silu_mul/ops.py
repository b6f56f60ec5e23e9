"""SiLU(gate) * up, the gated activation of a SwiGLU: the CUDA kernel
(``csrc/norm_rope_act.cu``, ``silu_mul_launch``) for CUDA tensors that
need no gradient, the plain version (``ref.py``) on the CPU, on meta
tensors and under autograd.  The kernel takes float32 or bfloat16, both
inputs in one dtype; CUDA tensors of other dtypes raise.

Replaces no Pallas kernel: the reference's ``jax.nn.silu(g) * u`` is jnp
ops that XLA fuses.  It was added because eager PyTorch runs it as two
kernels with the SiLU written to memory and read back, each a launch of
its own inside a replayed decode graph.  Bound: bytes (gate and up read
once, the product written once; a Yi-9B decode row moves 64 KiB), in
practice the launch.  Design: a grid-stride pass with 16-byte loads, the
SiLU rounded to the dtype before the product, as the plain version
rounds (the ``.cu`` file's note)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.silu_mul.ref import silu_mul_ref

__all__ = ["silu_mul"]


def silu_mul(gate, up):
    """SiLU(gate) * up, elementwise, in the inputs' dtype."""
    if not build.no_grad_on_cuda("silu_mul", gate, up):
        return silu_mul_ref(gate, up)
    if gate.shape != up.shape:
        raise ValueError(f"silu_mul: gate {tuple(gate.shape)} and up {tuple(up.shape)} differ")
    code = build.layer_dtype("silu_mul", gate, up)
    gate, up = gate.contiguous(), up.contiguous()
    out = torch.empty_like(gate)
    err = build.library().silu_mul_launch(gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                                          gate.numel(), code, build.stream_ptr(gate.device))
    build.check(err, "silu_mul")
    silu_mul.launches += 1
    return out


silu_mul.launches = 0
