"""Plain PyTorch version of the RoPE kernel: the rotate-half expression
``models.attention.rope`` ran before the kernel."""
from __future__ import annotations

import torch

__all__ = ["rope_freqs", "rope_ref"]


def rope_freqs(theta: float, hd: int, device) -> torch.Tensor:
    """The f32 frequencies [hd // 2] of head size ``hd``."""
    half = hd // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32, device=device) / half)


def rope_ref(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Angles in
    f32, output in x.dtype."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(theta, x.shape[-1], x.device)
    angles = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
