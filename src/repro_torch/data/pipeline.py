"""Synthetic tokenized LM data pipeline — deterministic, resumable.

A real deployment swaps ``SyntheticLMDataset`` for a file-backed source;
the iterator state (epoch, step) is part of the training checkpoint so a
restart replays from the exact batch (fault tolerance).

Copy of ``src/repro/data/pipeline.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLMDataset"]


@dataclasses.dataclass
class SyntheticLMDataset:
    """Zipf-distributed token stream with long-range repetition structure
    (so the loss actually decreases when training)."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict) -> None:
        self.seed = state["seed"]
        self.step = state["step"]

    def next_batch(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        # zipf-ish marginal + markov repetition: learnable structure
        base = rng.zipf(1.3, size=(self.batch_size, self.seq_len))
        tokens = np.minimum(base, self.vocab_size - 1).astype(np.int32)
        # inject copy structure: second half repeats first half shifted
        half = self.seq_len // 2
        tokens[:, half:] = np.roll(tokens[:, :half], -1, axis=1)
        return {"tokens": tokens}
