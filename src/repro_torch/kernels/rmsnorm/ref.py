"""Plain PyTorch versions of the RMSNorm kernels: the expressions the
model's ``layers.rmsnorm`` and its residual add ran before the kernel."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref", "add_rmsnorm_ref"]


def rmsnorm_ref(x, scale, eps: float):
    """Statistics in f32, times the scale in f32, one cast back to x's dtype."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * scale.float()).to(x.dtype)


def add_rmsnorm_ref(x, residual, scale, eps: float):
    """(x + residual, its RMSNorm)."""
    total = x + residual
    return total, rmsnorm_ref(total, scale, eps)
