"""Seeded random weights in the program's parameter layout, made on the
device with one ``torch.Generator`` there: one draw a stacked leaf (a
dozen or so calls for a whole model), in the dtype the model is served in.

The scales are the usual ones of a fresh model: embeddings, position and
meta-token tables and the router N(0, 0.02), a dense ``[in, out]`` matrix
N(0, in^-1/2), every expert matrix (the shared expert's too) N(0,
d_model^-1/2), norm scales 1 and biases 0.  The SSM's own leaves are as
Mamba-2's reference code sets them: ``a_log`` = log U[1, 16], ``dt_bias``
= softplus^-1(dt) with dt log-uniform in [1e-3, 1e-1] and floored at 1e-4,
``d_skip`` 1, and the depthwise convolution's weight and bias U(+-K^-1/2)
with K its width, a ``Conv1d``'s default.

A configuration's reference module may define ``weight_rule(leaf)``
(``Leaf`` below): it is consulted first, for that configuration alone, and
returns the leaf's tensor or None to leave the leaf to the defaults.  The
same tensors go to the program and to the plain reference."""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Leaf", "make_weights"]

# Mamba-2's initialisation of the SSM's per-head leaves
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 1e-1)
DT_FLOOR = 1e-4
# leaves of ones, of zeros, and tables drawn N(0, 0.02), by their last key
ONES = ("scale", "d_skip")
ZEROS = ("b", "bias")
TABLES = ("table", "meta", "dec_pos")


@dataclasses.dataclass
class Leaf:
    """One leaf to fill: its path in the tree, its meta tensor, the dict it
    sits in, and draws from the run's one generator in its shape, dtype and
    device."""

    path: tuple[str, ...]
    meta: torch.Tensor
    siblings: dict
    dtype: torch.dtype
    gen: torch.Generator
    device: object
    d_model: int

    @property
    def shape(self) -> torch.Size:
        return self.meta.shape

    def normal(self, std: float) -> torch.Tensor:
        return torch.randn(self.shape, generator=self.gen, dtype=self.dtype,
                           device=self.device).mul_(std)

    def uniform(self, lo: float, hi: float) -> torch.Tensor:
        """U[lo, hi), drawn in float32."""
        return torch.rand(self.shape, generator=self.gen, dtype=torch.float32,
                          device=self.device).mul_(hi - lo).add_(lo)

    def ones(self) -> torch.Tensor:
        return torch.ones(self.shape, dtype=self.dtype, device=self.device)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype, device=self.device)


def _dt_bias(leaf: Leaf) -> torch.Tensor:
    lo, hi = (math.log(x) for x in DT_RANGE)
    dt = leaf.uniform(lo, hi).exp_().clamp_(min=DT_FLOOR)
    return (dt + torch.log(-torch.expm1(-dt))).to(leaf.dtype)


def _conv(leaf: Leaf) -> torch.Tensor:
    """A depthwise ``Conv1d``'s default: U(+-1/sqrt(fan_in)), fan_in the
    kernel's width (``conv_w`` [..., K, channels])."""
    bound = leaf.siblings["conv_w"].shape[-2] ** -0.5
    return leaf.uniform(-bound, bound).to(leaf.dtype)


def default_rule(leaf: Leaf) -> torch.Tensor:
    """The defaults for every leaf the program's models hold; raises
    ``KeyError`` for any other."""
    path, name = leaf.path, leaf.path[-1]
    if name in ONES:
        return leaf.ones()
    if name in ZEROS:
        return leaf.zeros()
    if name in TABLES or path[-2:] == ("router", "w"):
        return leaf.normal(0.02)
    if "moe" in path:
        return leaf.normal(leaf.d_model ** -0.5)
    if name == "w":
        return leaf.normal(leaf.shape[-2] ** -0.5)
    if name == "a_log":
        return leaf.uniform(*A_RANGE).log_().to(leaf.dtype)
    if name == "dt_bias":
        return _dt_bias(leaf)
    if name in ("conv_w", "conv_b"):
        return _conv(leaf)
    raise KeyError(f"no weight rule for {'/'.join(path)}")


def make_weights(layout: dict, *, seed: int, device, d_model: int,
                 dtype: torch.dtype | None = None, rule=None) -> dict:
    """Fill a tree of meta tensors (``DecoderLM.param_shapes()``) with
    seeded draws on ``device``, leaf by leaf in the tree's order;
    ``dtype`` overrides the layout's; ``rule`` (a reference module's
    ``weight_rule``) goes before the defaults."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(node, path, parent):
        if isinstance(node, dict):
            return {k: fill(v, path + (k,), node) for k, v in node.items()}
        leaf = Leaf(path, node, parent, dtype or node.dtype, gen, device, d_model)
        out = rule(leaf) if rule is not None else None
        return default_rule(leaf) if out is None else out
    return fill(layout, (), {})
