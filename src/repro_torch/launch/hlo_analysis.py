"""Collective traffic of a run — the port of
``src/repro/launch/hlo_analysis.py``.

The reference reads the collectives out of compiled HLO text.  The port
has no compiler in between: its model code runs each collective itself
and records it (``models.sharding.COUNTER``), so the stats are built from
those records.  A record's bytes are its shape's (the rank's result, as
an HLO op's shape is), in its own dtype.

Bytes-on-the-wire model (ring algorithms, n = participants), the
reference's:
  all-gather         : out_bytes                 (each device receives ≈ out)
  all-reduce         : 2 × bytes                 (reduce-scatter + all-gather)
  reduce-scatter     : in_bytes
  all-to-all         : bytes
  collective-permute : bytes
A reduce-scatter's record holds this rank's slice (its result), so its
in_bytes are the slice's times the group size.

A train step (``train_step_stats``) splits its records by direction: the
forward (the loss's, with a remat'd group's recompute in the backward,
whose records are forward ones) and the backward (autograd's: the
reduce-scatters of the FSDP gathers, ``copy_to_model``'s sums, the
inverse all-to-alls; then the DP gradient sums and the clip's norm).
"""
from __future__ import annotations

import dataclasses

__all__ = ["CollectiveStats", "collective_stats", "train_step_stats"]

_COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)
_WIRE_FACTOR = {
    "all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    by_kind_bytes: dict[str, int]
    by_kind_count: dict[str, int]
    wire_bytes: float  # with ring-model factors
    f32_wire_bytes: float = 0.0  # share of wire moving f32 payloads

    @property
    def total_bytes(self) -> int:
        return sum(self.by_kind_bytes.values())

    @property
    def wire_bytes_bf16_adjusted(self) -> float:
        """The wire bytes with every f32 payload moved in bf16 (its share
        halved).  The reference halves its f32 share because XLA:CPU
        emulates bf16 in f32; the port records each collective in the dtype
        it runs in, and its f32 payloads are real: the row-parallel and
        embedding sums, which it keeps in f32 on purpose, and gradient
        sums.  So here this is a bound for a deployment that would sum
        activations in bf16, not a correction."""
        return self.wire_bytes - 0.5 * self.f32_wire_bytes


def collective_stats(records) -> CollectiveStats:
    """``models.sharding.CollectiveRecord``s → stats by kind."""
    import torch

    by_bytes: dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
    by_count: dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
    wire = 0.0
    f32_wire = 0.0
    for r in records:
        by_bytes[r.kind] += r.nbytes
        by_count[r.kind] += 1
        on_wire = r.nbytes * _WIRE_FACTOR[r.kind]
        if r.kind == "reduce-scatter":
            on_wire *= r.group_size   # in_bytes: the record holds the slice
        wire += on_wire
        if r.dtype == torch.float32:
            f32_wire += on_wire
    return CollectiveStats(by_bytes, by_count, wire, f32_wire)


def train_step_stats(records) -> dict[str, CollectiveStats]:
    """A train step's records → {"forward": stats, "backward": stats}."""
    return {d: collective_stats([r for r in records if r.direction == d])
            for d in ("forward", "backward")}
