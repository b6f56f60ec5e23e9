"""JAX <-> port conversion for parity tests, without importing JAX.

The JAX package's params are a pytree of dicts whose leaves the caller
turns into numpy arrays (``jax.tree.map(np.asarray, params)``); the port
uses the same dict layout (dense ``w`` as ``[in, out]``, layers stacked
``[L, ...]``), so conversion is a leaf-by-leaf copy.  bf16 numpy arrays
(numpy's ``bfloat16`` extension dtype) are carried bit for bit through
their 16-bit pattern.  ``DecodeState`` converts both ways through its
paged-KV fields.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import DecodeState

__all__ = ["tensor_from_numpy", "params_from_jax", "state_from_jax", "state_to_numpy"]

_STATE_FIELDS = ("context_lens", "k_pages", "v_pages", "block_tables")


def tensor_from_numpy(a, *, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.array(a)  # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree, *, device="cpu", dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> nested dict of tensors (optionally
    cast to ``dtype``)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device, dtype=dtype) for k, v in tree.items()}
    return tensor_from_numpy(tree, device=device, dtype=dtype)


def state_from_jax(state, *, device="cpu", dtype: torch.dtype | None = None) -> DecodeState:
    """A JAX ``DecodeState`` whose leaves are numpy arrays -> port state.
    ``dtype`` applies to the KV pages only."""
    def conv(name):
        a = getattr(state, name)
        if a is None:
            return None
        return tensor_from_numpy(a, device=device,
                                 dtype=dtype if name.endswith("pages") else None)
    return DecodeState(**{f: conv(f) for f in _STATE_FIELDS})


def state_to_numpy(state: DecodeState) -> dict[str, np.ndarray | None]:
    """Port state -> dict of numpy arrays (f32 pages for bf16 ones), the
    keyword arguments of the JAX ``DecodeState``."""
    out = {}
    for f in _STATE_FIELDS:
        t = getattr(state, f)
        if t is not None and t.dtype == torch.bfloat16:
            t = t.float()
        out[f] = None if t is None else t.detach().cpu().numpy()
    return out
