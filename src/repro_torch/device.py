"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  A
request for CUDA on a machine without a GPU raises: nothing quietly
carries on on the CPU.  ``meta`` is taken when asked for by name: shapes
and dtypes only, for the dry-run (``launch.dryrun``), where the kernels'
wrappers return outputs of the right shapes and count their work.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch paths)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda', 'cpu' or 'meta'")
    return dev
