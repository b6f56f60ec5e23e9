"""The one traffic generator: an open-loop arrival schedule from a mix's
parameters (``traffic/<mix>.json``), the cell's rate and the run's seed.

The length and gap arithmetic is a frozen copy of
``src/repro_torch/sim/workloads.py`` (``_lognormal_with_mean``: lengths
lognormal around a mean, ``sample_requests``: exponential gaps of a Poisson
process, clipped lengths).  What differs: the values are not drawn afresh
for every seed.  The schedule is cut into segments (a run's lead, its
window, its drain); a segment of D seconds holds n = round(rate x D)
arrivals: n stratified quantiles of the prompt length paired with n of the
answer length (a pairing drawn from n alone, the same for every seed), and
n stratified quantiles of the exponential gap scaled to fill the segment
exactly; the seed draws the order of the pairs and of the gaps.  So every
seed offers the same requests in each segment, in another order and with
other token ids: runs of two seeds differ by the order of the work, not by
its amount.

A mix may set ``block``: the segment's arrivals then come in consecutive
blocks of about that many, and each block holds one pair from each of the
``block`` strata of the answer length (and one gap from each stratum of
the gaps).  The seed draws which pair of a stratum goes to which block, and
the order inside each block.  Without it a seed may put the longest answers
together, and the decode batch of a window, with its step time, moves with
the seed; with it every stretch of a few blocks carries about the same load
for every seed.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

__all__ = ["Arrival", "schedule", "balanced_order", "quantile_lengths", "quantile_gaps"]

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass(frozen=True)
class Arrival:
    offset_s: float        # due time, from the start of the schedule
    prompt: np.ndarray     # int64 token ids
    output_len: int        # tokens served in all, the first (from prefill) included


def _lognormal_mu(mean: float, sigma: float) -> float:
    """``sim/workloads.py::_lognormal_with_mean``'s location parameter."""
    return math.log(mean) - 0.5 * sigma * sigma


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles ((i + 0.5) / n) of a lognormal with
    mean ``spec["mean"]`` and shape ``spec["sigma"]``, clipped to
    [``min``, ``max``], as whole tokens."""
    mu = _lognormal_mu(float(spec["mean"]), float(spec["sigma"]))
    q = [math.exp(mu + spec["sigma"] * _NORMAL.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.asarray(q), spec["min"], spec["max"]).astype(np.int64)


def quantile_gaps(rate: float, n: int) -> np.ndarray:
    """The ``n`` stratified quantiles of an exponential gap, scaled so that
    they average 1 / ``rate`` exactly."""
    g = np.asarray([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    return g / g.mean() / rate


def balanced_order(n: int, block: int, rng) -> np.ndarray:
    """A permutation of ``range(n)`` (ranks, 0 the smallest) laid out in
    consecutive blocks of at most ``block``: rank r lies in stratum
    r // ceil(n / block), and each block takes at most one rank of each
    stratum.  ``rng`` draws which rank of a stratum goes to which block and
    the order inside each block; ``block >= n`` is a plain permutation."""
    if block >= n:
        return rng.permutation(n)
    nb = -(-n // max(1, block))             # blocks, and ranks a stratum
    blocks: list[list[int]] = [[] for _ in range(nb)]
    for lo in range(0, n, nb):
        members = np.arange(lo, min(lo + nb, n))
        for b, r in zip(rng.permutation(nb), members):
            blocks[b].append(int(r))
    return np.concatenate([np.asarray(b)[rng.permutation(len(b))] for b in blocks])


def schedule(mix: dict, *, rate: float, segments, seed: int, vocab: int) -> list[Arrival]:
    """Arrivals at ``rate`` requests a second over consecutive segments of
    the given lengths (seconds), the first due at 0; prompt ids uniform
    over [0, ``vocab``)."""
    if mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrival process {mix['arrivals']!r}")
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    out: list[Arrival] = []
    start = 0.0
    for dur in segments:
        n = max(1, round(rate * dur))
        block = int(mix.get("block", n))
        gaps = quantile_gaps(n / dur, n)[balanced_order(n, block, rng)]
        pairing = np.random.default_rng(n).permutation(n)
        prompts = quantile_lengths(mix["prompt"], n)
        outputs = quantile_lengths(mix["output"], n)[pairing]
        # strata by answer length, then prompt length: the work a request brings
        by_work = np.lexsort((prompts, outputs))
        order = by_work[balanced_order(n, block, rng)]
        prompts, outputs = prompts[order], outputs[order]
        t = start
        for i in range(n):
            out.append(Arrival(t, rng.integers(0, vocab, int(prompts[i]), dtype=np.int64),
                               int(outputs[i])))
            t += float(gaps[i])
        start += dur
    return out
