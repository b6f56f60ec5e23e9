"""Greedy tokens of two runs compared under the bf16 margin rule.

Two runs of one model that round bf16 in other places (one card against
tensor parallelism over four, the port against the JAX package) may pick
different greedy tokens where the reference's best two logits lie within
the rounding of each other: both picks are right.  So a token is required
to equal the reference's only where the reference's top-2 margin at that
step exceeds the stated tolerance; from the first step of a sequence whose
margin falls short, nothing more of that sequence is compared (its later
inputs may differ).
"""
from __future__ import annotations

import torch

__all__ = ["top2_margin", "check_greedy_tokens"]


def top2_margin(logits: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """[b, V] logits -> [b] f32: the best logit less the second best, over
    the first ``vocab`` columns."""
    x = logits[:, :vocab].float() if vocab else logits.float()
    top = torch.topk(x, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def check_greedy_tokens(ref_logits, ref_tokens, tokens, tol: float, *,
                        vocab: int | None = None) -> dict:
    """``ref_logits[t]`` [b, V]: the reference's logits that chose
    ``ref_tokens[t]`` [b]; ``tokens[t]`` [b]: the other run's.  Raises
    AssertionError where a compared token differs; returns how many tokens
    were compared and, for each sequence, the first step not compared
    (None when every step was)."""
    b = len(ref_tokens[0])
    stop: list[int | None] = [None] * b
    compared = 0
    for t, (lg, want, got) in enumerate(zip(ref_logits, ref_tokens, tokens)):
        margin = top2_margin(torch.as_tensor(lg), vocab)
        for row in range(b):
            if stop[row] is not None:
                continue
            if not float(margin[row]) > tol:
                stop[row] = t
                continue
            if int(got[row]) != int(want[row]):
                raise AssertionError(
                    f"sequence {row}, step {t}: token {int(got[row])} != reference "
                    f"{int(want[row])} with the reference's top-2 margin "
                    f"{float(margin[row]):.4g} above {tol}")
            compared += 1
    return {"compared": compared, "first_uncompared_step": stop}
