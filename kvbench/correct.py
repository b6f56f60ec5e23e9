"""What decides ``correct``: a sample of the requests the service finished,
drawn from the seed with the longest among them, run once through the
plain float32 reference over its prompt and served tokens.  The number
compared is the widest gap by which a served token's reference logit lies
below the reference's best logit at its position (every served token is
greedy).  The control is the reference in float8 (``fp8=True``) in the
program's place: at the same positions, the gap of the token it puts
first."""
from __future__ import annotations

import numpy as np

__all__ = ["sample", "gaps", "BIG_GAP"]

# A gap past this many logits is a departure, not a near tie resolved the
# other way: about ten roundings of one logit in bfloat16 (2^-9 relative)
# at these widths' logits of a few units.
BIG_GAP = 0.05


def sample(reqs, seed: int, target_tokens: int) -> list:
    """The finished request with the most served tokens, then others in an
    order drawn from ``seed`` until ``target_tokens`` served tokens."""
    done = [r for r in reqs if r.done]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.output_len, r.prompt_len, r.due))
    picked, total = [longest], longest.output_len
    for j in np.random.default_rng([seed, 7]).permutation(len(done)):
        if total >= target_tokens:
            break
        if done[j] is not longest:
            picked.append(done[j])
            total += done[j].output_len
    return picked


def _readings(best, second, judged) -> dict:
    """Over one or more positions: the widest gap, the summed gap, the
    summed margin between the reference's two best logits, and the
    positions whose judged token is not the reference's best."""
    gap = best - judged
    return {"max_logit_gap": float(gap.max()), "sum_gap": float(gap.sum()),
            "sum_margin": float((best - second).sum()),
            "mismatches": int((gap > 0).sum()), "big": int((gap > BIG_GAP).sum()),
            "n": int(gap.numel())}


def _merge(acc: dict | None, r: dict) -> dict:
    if acc is None:
        return dict(r)
    return {k: max(acc[k], r[k]) if k == "max_logit_gap" else acc[k] + r[k] for k in r}


def _final(acc: dict) -> dict:
    """The numbers a cell may compare: the widest gap, the mean gap, the
    summed gap over the summed two-best margin, the share of positions not
    the reference's best, and the share whose gap exceeds ``BIG_GAP``."""
    return {"max_logit_gap": acc["max_logit_gap"], "mean_logit_gap": acc["sum_gap"] / acc["n"],
            "gap_per_margin": acc["sum_gap"] / acc["sum_margin"],
            "mismatch_share": acc["mismatches"] / acc["n"],
            "big_gap_share": acc["big"] / acc["n"], "positions": acc["n"]}


def gaps(reference, weights, m: dict, reqs, device, *, control: bool = False) -> dict:
    """Readings over ``reqs`` of the served tokens (``served``) and, with
    ``control``, of the float8 reference's first choices (``control``),
    each judged by its gap below the reference's best logit (``_final``);
    with ``control`` also every position's margin and two gaps
    (``detail``)."""
    import torch

    served = low = None
    detail: dict[str, list] = {}
    for r in reqs:
        toks = r.tokens[: r.output_len]
        seq = torch.as_tensor(np.concatenate([r.prompt, np.asarray(toks[:-1], dtype=np.int64)]),
                              device=device)
        rows = torch.arange(r.prompt_len - 1, r.prompt_len - 1 + len(toks), device=device)
        ref = reference.logits(weights, m, seq, rows)
        top = ref.topk(2, dim=-1).values
        best, second = top[:, 0], top[:, 1]
        got = ref.gather(1, torch.as_tensor(toks, device=device)[:, None])[:, 0]
        served = _merge(served, _readings(best, second, got))
        if control:
            first = reference.logits(weights, m, seq, rows, fp8=True).argmax(dim=-1)
            low_got = ref.gather(1, first[:, None])[:, 0]
            low = _merge(low, _readings(best, second, low_got))
            for k, v in (("margin", best - second), ("served", best - got),
                         ("control", best - low_got)):
                detail.setdefault(k, []).extend(v.tolist())
        del ref
    out = {"served": _final(served)}
    if control:
        out["control"] = _final(low)
        out["detail"] = detail
    return out
