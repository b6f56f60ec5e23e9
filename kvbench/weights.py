"""Seeded random weights in the program's parameter layout, made on the
device with one ``torch.Generator`` there: one draw a stacked leaf (a
dozen or so calls for a whole model), in the dtype the model is served in.

The scales are the usual ones of a fresh model: embeddings and the router
N(0, 0.02), a dense ``[in, out]`` matrix N(0, in^-1/2), every expert matrix
N(0, d_model^-1/2), norm scales 1.  The same tensors go to the program and
to the plain reference."""
from __future__ import annotations

import torch

__all__ = ["make_weights"]


def _scale(path: tuple[str, ...], shape, d_model: int) -> float | None:
    """None: a norm scale (ones)."""
    if path[-1] == "scale":
        return None
    if path[-1] == "table" or path[-2:] == ("router", "w"):
        return 0.02
    if len(path) >= 2 and path[-2] == "moe":
        return d_model ** -0.5
    if path[-1] == "w" and path[-3] in ("attn", "mlp"):
        return shape[-2] ** -0.5
    raise KeyError(f"no weight rule for {'/'.join(path)}")


def make_weights(layout: dict, *, seed: int, device, d_model: int,
                 dtype: torch.dtype | None = None) -> dict:
    """Fill a tree of meta tensors (``DecoderLM.param_shapes()``) with
    seeded draws on ``device``; ``dtype`` overrides the layout's."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(node, path):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,)) for k, v in node.items()}
        dt = dtype or node.dtype
        sc = _scale(path, node.shape, d_model)
        if sc is None:
            return torch.ones(node.shape, dtype=dt, device=device)
        return torch.randn(node.shape, generator=gen, dtype=dt, device=device).mul_(sc)
    return fill(layout, ())
