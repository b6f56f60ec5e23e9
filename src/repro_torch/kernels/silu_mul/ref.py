"""Plain PyTorch version of the gated activation kernel: the expression
``layers.swiglu`` and the experts' ``models.moe._ffn_local`` ran before
the kernel."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["silu_mul_ref"]


def silu_mul_ref(gate, up):
    """SiLU(gate) * up: the SiLU rounded to gate's dtype, then the product."""
    return F.silu(gate) * up
