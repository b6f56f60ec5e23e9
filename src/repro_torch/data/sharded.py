"""Each rank's rows of a global batch under a device mesh.

``pipeline.py`` stays a copy of the reference's data pipeline (the
global batch, the same on every rank, from ``(seed, step)``); under a
mesh each rank keeps the rows ``launch.shardings.batch_spec`` gives it,
as the reference's jitted step takes its batch sharded by that spec.
"""
from __future__ import annotations

import torch

from repro_torch.launch.shardings import batch_spec, spec_axes
from repro_torch.models import sharding

__all__ = ["rank_rows"]


def rank_rows(batch: dict, mesh, *, fold_model: bool = False) -> tuple[dict, tuple[str, ...]]:
    """The global ``batch`` (arrays or tensors with the batch leading) ->
    (this rank's rows of every entry, the mesh axes they are split over).
    The rows are contiguous: rank i of the split axes (row-major) holds
    rows [i * b / n, (i + 1) * b / n)."""
    b = len(batch["tokens"])
    spec = batch_spec(mesh, b, fold_model=fold_model)
    axes = spec_axes(spec[0]) if spec else ()
    with sharding.mesh_context(mesh, fold_model_axis=fold_model):
        rows = {k: sharding.take_shard(torch.as_tensor(v), axes, 0) for k, v in batch.items()}
    return rows, axes
