"""Synthetic workloads matching the paper's two datasets (§5.1).

  arXiv     — long prompts, short responses: mean prompt 40,642 tokens,
              mean response 241 tokens (summarization).
  ShareGPT  — shorter prompts, long responses: mean prompt 20,471,
              mean response 2,328 (chat continuation).

Lengths are lognormal around the paper's means (real length
distributions are heavy-tailed); arrivals are a Poisson process, as in
the paper.  Everything is seeded for reproducibility.

Copy of ``src/repro/sim/workloads.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WorkloadSpec", "ARXIV", "SHAREGPT", "sample_requests", "fixed_requests",
           "shared_prefix_requests", "bursty_requests", "diurnal_requests"]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    mean_prompt: float
    mean_response: float
    sigma: float = 0.6  # lognormal shape
    max_prompt: int = 131_072
    max_response: int = 8_192


ARXIV = WorkloadSpec("arxiv", mean_prompt=40_642, mean_response=241)
SHAREGPT = WorkloadSpec("sharegpt", mean_prompt=20_471, mean_response=2_328)


def _lognormal_with_mean(rng, mean: float, sigma: float, n: int) -> np.ndarray:
    mu = np.log(mean) - 0.5 * sigma * sigma
    return rng.lognormal(mu, sigma, n)


@dataclasses.dataclass(frozen=True)
class SimRequest:
    request_id: str
    arrival_s: float
    prompt_len: int
    response_len: int
    # Shared-prefix identity for delta transfer / prefix-affinity sims:
    # requests with the same prefix_id share their first prefix_len
    # prompt tokens (0 with a prefix_id = the whole prompt).
    prefix_id: str | None = None
    prefix_len: int = 0
    # SLO class, for priority-ordered preemption victims and the SLO
    # admission policy (interactive | standard | batch).
    slo_class: str = "standard"


def sample_requests(spec: WorkloadSpec, *, qps: float, duration_s: float,
                    seed: int = 0) -> list[SimRequest]:
    rng = np.random.default_rng(seed)
    n = max(1, int(qps * duration_s * 1.2))
    gaps = rng.exponential(1.0 / qps, n)
    arrivals = np.cumsum(gaps)
    arrivals = arrivals[arrivals < duration_s]
    n = len(arrivals)
    prompts = np.clip(_lognormal_with_mean(rng, spec.mean_prompt, spec.sigma, n),
                      16, spec.max_prompt).astype(int)
    responses = np.clip(_lognormal_with_mean(rng, spec.mean_response, spec.sigma, n),
                        1, spec.max_response).astype(int)
    return [
        SimRequest(f"{spec.name}-{i}", float(arrivals[i]), int(prompts[i]), int(responses[i]))
        for i in range(n)
    ]


def fixed_requests(prompt_len: int, response_len: int, *, qps: float,
                   duration_s: float, seed: int = 0) -> list[SimRequest]:
    """Fig. 12-style fixed workloads, e.g. 8192-512."""
    rng = np.random.default_rng(seed)
    n = max(1, int(qps * duration_s * 1.2))
    arrivals = np.cumsum(rng.exponential(1.0 / qps, n))
    arrivals = arrivals[arrivals < duration_s]
    return [
        SimRequest(f"fixed-{i}", float(a), prompt_len, response_len)
        for i, a in enumerate(arrivals)
    ]


def _lengths(rng, spec: WorkloadSpec, n: int) -> tuple[np.ndarray, np.ndarray]:
    prompts = np.clip(_lognormal_with_mean(rng, spec.mean_prompt, spec.sigma, n),
                      16, spec.max_prompt).astype(int)
    responses = np.clip(_lognormal_with_mean(rng, spec.mean_response, spec.sigma, n),
                        1, spec.max_response).astype(int)
    return prompts, responses


def bursty_requests(spec: WorkloadSpec, *, qps_on: float, qps_off: float,
                    mean_on_s: float, mean_off_s: float, duration_s: float,
                    seed: int = 0) -> list[SimRequest]:
    """On/off Markov-modulated Poisson arrivals — the elastic-scaling
    stressor (benchmarks/fig_elastic.py).

    The process alternates between an ON phase (rate ``qps_on``) and an
    OFF phase (rate ``qps_off``), with exponentially distributed phase
    lengths (means ``mean_on_s`` / ``mean_off_s``), starting ON.  A
    static fleet sized for the mean under-provisions the bursts and
    over-provisions the lulls; an autoscaler can track the phases.

    Seeded and deterministic: the SAME request list (ids, arrival times,
    lengths) drives both ``sim.ClusterSim`` and the real serving
    substrate, so sim-vs-real comparisons share the workload
    byte-for-byte.
    """
    rng = np.random.default_rng(seed)
    arrivals: list[float] = []
    t, on = 0.0, True
    while t < duration_s:
        end = min(t + rng.exponential(mean_on_s if on else mean_off_s),
                  duration_s)
        qps = qps_on if on else qps_off
        if qps > 0:
            a = t + rng.exponential(1.0 / qps)
            while a < end:
                arrivals.append(a)
                a += rng.exponential(1.0 / qps)
        t, on = end, not on
    prompts, responses = _lengths(rng, spec, len(arrivals))
    return [
        SimRequest(f"burst-{i}", float(a), int(prompts[i]), int(responses[i]))
        for i, a in enumerate(arrivals)
    ]


def diurnal_requests(spec: WorkloadSpec, *, qps_peak: float, qps_trough: float,
                     period_s: float, duration_s: float,
                     seed: int = 0) -> list[SimRequest]:
    """Sinusoidal daily-cycle arrivals via Lewis thinning: a homogeneous
    Poisson process at ``qps_peak`` is thinned to the instantaneous rate

        λ(t) = trough + (peak − trough) · (1 + sin(2πt/period)) / 2

    — the smooth counterpart of ``bursty_requests`` (hours-scale drift
    instead of seconds-scale bursts), for autoscaler experiments where
    the fleet should track a slow swell without thrashing.  Seeded and
    deterministic like every generator here.
    """
    if qps_trough > qps_peak:
        raise ValueError(f"qps_trough {qps_trough} exceeds qps_peak {qps_peak}")
    rng = np.random.default_rng(seed)
    arrivals: list[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / qps_peak)
        if t >= duration_s:
            break
        lam = qps_trough + (qps_peak - qps_trough) * \
            0.5 * (1.0 + np.sin(2.0 * np.pi * t / period_s))
        if rng.uniform() < lam / qps_peak:
            arrivals.append(t)
    prompts, responses = _lengths(rng, spec, len(arrivals))
    return [
        SimRequest(f"diurnal-{i}", float(a), int(prompts[i]), int(responses[i]))
        for i, a in enumerate(arrivals)
    ]


def shared_prefix_requests(prompt_len: int, response_len: int, *, qps: float,
                           duration_s: float, prefix_frac: float = 0.5,
                           n_prefixes: int = 4, seed: int = 0) -> list[SimRequest]:
    """Delta-transfer workload: fixed-shape requests where each arrival
    shares the first ``prefix_frac`` of its prompt with every other
    request carrying the same prefix id (``n_prefixes`` distinct shared
    system prompts, assigned uniformly at random).  With delta transfer
    on, every request after a prefix's first pull moves only the
    remaining ``1 - prefix_frac`` suffix."""
    if not 0.0 <= prefix_frac <= 1.0:
        raise ValueError(f"prefix_frac must be in [0, 1], got {prefix_frac}")
    rng = np.random.default_rng(seed)
    n = max(1, int(qps * duration_s * 1.2))
    arrivals = np.cumsum(rng.exponential(1.0 / qps, n))
    arrivals = arrivals[arrivals < duration_s]
    prefix_len = int(prompt_len * prefix_frac)
    picks = rng.integers(0, max(n_prefixes, 1), len(arrivals))
    return [
        SimRequest(f"pfx-{i}", float(a), prompt_len, response_len,
                   prefix_id=f"prefix{picks[i]}", prefix_len=prefix_len)
        for i, a in enumerate(arrivals)
    ]
