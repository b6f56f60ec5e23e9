"""JAX <-> port conversion for parity tests, without importing JAX.

The JAX package's params are a pytree of dicts whose leaves the caller
turns into numpy arrays (``jax.tree.map(np.asarray, params)``); the port
uses the same dict layout (dense ``w`` as ``[in, out]``, layers stacked
``[L, ...]``), so conversion is a leaf-by-leaf copy.  bf16 numpy arrays
(numpy's ``bfloat16`` extension dtype) are carried bit for bit through
their 16-bit pattern.  ``DecodeState`` converts both ways through all its
fields (paged KV, ring KV, meta KV and SSM state), and so does the
encoder-decoder's ``EncDecState`` (self-KV pages and cross-attention KV).
The AdamW state (``opt_state_from_jax``) crosses with its structure and
dtypes (f32 or bf16 moments, the f32 master copy, the int32 step), so a
train step of either framework can start from the other's state.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.transformer import DecodeState
from repro_torch.models.whisper import EncDecState

__all__ = ["tensor_from_numpy", "params_from_jax", "opt_state_from_jax", "state_from_jax",
           "state_to_numpy"]

_KV_FIELDS = ("k_pages", "v_pages", "ring_k", "ring_v", "meta_k", "meta_v", "cross_k",
              "cross_v")


def tensor_from_numpy(a, *, device="cpu", dtype: torch.dtype | None = None) -> torch.Tensor:
    a = np.array(a)  # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree, *, device="cpu", dtype: torch.dtype | None = None, mesh=None,
                    mode: str = "serve", fold_model: bool = False):
    """Nested dict of numpy arrays -> nested dict of tensors (optionally
    cast to ``dtype``); with a ``mesh`` (``launch.mesh.Mesh``), this rank's
    shards of them (``launch.shardings.shard_params`` in ``mode``)."""
    if isinstance(tree, dict):
        out = {k: params_from_jax(v, device=device, dtype=dtype) for k, v in tree.items()}
    else:
        out = tensor_from_numpy(tree, device=device, dtype=dtype)
    if mesh is None:
        return out
    from repro_torch.launch.shardings import shard_params

    return shard_params(out, mesh, mode=mode, fold_model=fold_model)


def opt_state_from_jax(opt_state, *, device="cpu", mesh=None, fold_model: bool = False):
    """A JAX AdamW state (``{"step", "m", "v"[, "master"]}``) whose leaves
    are numpy arrays -> the port's ``optim.adamw`` state: the same dicts,
    every leaf in its own dtype; with a ``mesh``, this rank's shards of the
    moments and master copy, placed as the params in training
    (``launch.shardings.opt_state_sharding``)."""
    out = {k: params_from_jax(v, device=device, mesh=mesh, mode="train", fold_model=fold_model)
           for k, v in opt_state.items() if k != "step"}
    out["step"] = tensor_from_numpy(opt_state["step"], device=device, dtype=torch.int32)
    return out


def state_from_jax(state, *, device="cpu", dtype: torch.dtype | None = None):
    """A JAX ``DecodeState`` or ``EncDecState`` whose leaves are numpy
    arrays -> the port's state of the same kind.  ``dtype`` applies to the
    KV tensors (pages, ring, meta, cross) only: the SSD state stays f32
    and the conv state keeps its own dtype."""
    def conv(name):
        a = getattr(state, name)
        if a is None:
            return None
        return tensor_from_numpy(a, device=device,
                                 dtype=dtype if name in _KV_FIELDS else None)
    cls = EncDecState if hasattr(state, "cross_k") else DecodeState
    return cls(**{f.name: conv(f.name) for f in dataclasses.fields(cls) if f.name != "layout"})


def state_to_numpy(state) -> dict[str, np.ndarray | None]:
    """Port state (``DecodeState`` or ``EncDecState``) -> dict of numpy
    arrays (f32 for bf16 tensors), the keyword arguments of the JAX state
    of the same kind."""
    out = {}
    for f in (f.name for f in dataclasses.fields(state) if f.name != "layout"):
        t = getattr(state, f)
        if t is not None and t.dtype == torch.bfloat16:
            t = t.float()
        out[f] = None if t is None else t.detach().cpu().numpy()
    return out
