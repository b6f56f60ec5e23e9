"""Pluggable placement policies for the request router.

Every policy sees the same inputs — a ``RouteRequest`` describing the
request and a list of ``Candidate`` workers with their current load and
(for decode candidates) the modeled cost of pulling this request's KV
over that worker's link — and returns the chosen candidate.  The same
objects drive the real serving layer and the discrete-event simulator,
so ``Candidate`` units are whatever the caller uses consistently (blocks
in serving, tokens in the simulator).

Policies:

  * ``round_robin``   — cycles candidates; the no-information baseline.
  * ``least_loaded``  — minimizes in-use + queued capacity fraction
    (FlowKV-style load awareness).
  * ``network_aware`` — decode selection minimizes the modeled transfer
    cost of the request's KV footprint over the candidate's link
    (NetKV-style path awareness), tie-broken by load; prefill selection
    falls back to least-loaded.
  * ``prefix_affinity`` — decode selection prefers the worker already
    holding the request's shared prefix (BlockPool-refcount residency,
    reported via ``LoadReport.prefix_ids``); falls back to least-loaded.
  * ``slo``           — TTFT deadline classes with an admission
    controller: picks the placement minimizing projected TTFT and
    rejects (or queues) requests whose projection exceeds their class
    deadline, protecting already-admitted traffic.

Adding a policy: subclass ``Policy``, implement ``pick_prefill`` /
``pick_decode`` (and optionally ``admit``), and register it in
``POLICIES`` (see docs/scheduling.md).

Copy of ``src/repro/sched/policies.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

__all__ = [
    "RouteRequest",
    "Candidate",
    "Policy",
    "RoundRobinPolicy",
    "LeastLoadedPolicy",
    "NetworkAwarePolicy",
    "PrefixAffinityPolicy",
    "SLOAwarePolicy",
    "DEFAULT_SLO_CLASSES",
    "POLICIES",
    "make_policy",
]

# TTFT deadline classes (seconds).  "batch" traffic is never rejected.
DEFAULT_SLO_CLASSES: dict[str, float] = {
    "interactive": 0.5,
    "standard": 2.0,
    "batch": math.inf,
}


@dataclasses.dataclass(frozen=True)
class RouteRequest:
    """What a policy may know about a request before placing it."""

    request_id: str
    prompt_len: int
    kv_bytes: int = 0          # full KV footprint to be pulled decode-side
    slo_class: str = "standard"
    arrival_s: float = 0.0
    prefix_id: str | None = None  # shared-prefix identity (prefix routing)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One worker as seen by a policy.  ``*_units`` are capacity in the
    caller's unit (blocks for serving, tokens for the simulator);
    ``ready_s`` is the projected wait until the worker could start this
    request; ``transfer_cost_s`` is the modeled KV pull cost over this
    worker's link (decode candidates only)."""

    worker_id: str
    free_units: float = 1.0
    total_units: float = 1.0
    queued_units: float = 0.0
    resident: int = 0
    ready_s: float = 0.0
    transfer_cost_s: float = 0.0
    prefix_hit: float = 0.0  # 1.0 iff this worker holds the request's prefix

    @property
    def load_score(self) -> float:
        used = self.total_units - self.free_units + self.queued_units
        return used / max(self.total_units, 1e-9)


class Policy:
    """Base class: pick a prefill candidate, pick a decode candidate,
    and vote on admission.  Candidates are never empty."""

    name = "policy"

    def pick_prefill(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        raise NotImplementedError

    def pick_decode(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        raise NotImplementedError

    def admit(self, ctx: RouteRequest, projected_ttft_s: float) -> bool:
        return True


class RoundRobinPolicy(Policy):
    name = "round_robin"

    def __init__(self) -> None:
        self._next = {"prefill": 0, "decode": 0}

    def _pick(self, role: str, cands: Sequence[Candidate]) -> Candidate:
        ordered = sorted(cands, key=lambda c: c.worker_id)
        chosen = ordered[self._next[role] % len(ordered)]
        self._next[role] += 1
        return chosen

    def pick_prefill(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return self._pick("prefill", cands)

    def pick_decode(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return self._pick("decode", cands)


class LeastLoadedPolicy(Policy):
    name = "least_loaded"

    def pick_prefill(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return min(cands, key=lambda c: (c.load_score, c.ready_s, c.worker_id))

    def pick_decode(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return min(cands, key=lambda c: (c.load_score, c.ready_s, c.worker_id))


class NetworkAwarePolicy(LeastLoadedPolicy):
    """NetKV-style: the decode instance is chosen by the network path the
    KV cache will traverse, not just by free memory.  Load still breaks
    ties so a congested-but-close worker doesn't absorb everything."""

    name = "network_aware"

    def pick_decode(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return min(cands, key=lambda c: (c.transfer_cost_s, c.load_score, c.worker_id))


class PrefixAffinityPolicy(LeastLoadedPolicy):
    """Prefix-cache-aware decode placement: prefer the worker whose
    BlockPool still holds the request's shared prefix resident
    (``Candidate.prefix_hit``), so a follow-up request lands where its
    prefix KV already lives.  Routing affinity only for now — the pull
    still moves the full prompt; adopting the retained blocks at admit
    time (skipping the prefix's reads) is the follow-up that turns the
    hit into a transfer saving (see docs/serving.md).  With no hit
    anywhere the sort key degenerates to least-loaded — the documented
    fallback."""

    name = "prefix_affinity"

    def pick_decode(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return min(cands, key=lambda c: (
            -c.prefix_hit, c.load_score, c.ready_s, c.worker_id))


class SLOAwarePolicy(LeastLoadedPolicy):
    """TTFT deadline classes + admission control.  Placement minimizes
    projected start time (the TTFT-critical term); ``admit`` rejects a
    request whose projected TTFT already exceeds its class deadline, so
    admitted traffic keeps its SLO instead of everyone missing it."""

    name = "slo"

    def __init__(self, classes: Mapping[str, float] | None = None) -> None:
        self.classes = dict(classes or DEFAULT_SLO_CLASSES)

    def deadline_s(self, ctx: RouteRequest) -> float:
        return self.classes.get(ctx.slo_class, math.inf)

    def pick_prefill(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return min(cands, key=lambda c: (c.ready_s, c.load_score, c.worker_id))

    def pick_decode(self, ctx: RouteRequest, cands: Sequence[Candidate]) -> Candidate:
        return min(cands, key=lambda c: (c.transfer_cost_s + c.ready_s, c.load_score, c.worker_id))

    def admit(self, ctx: RouteRequest, projected_ttft_s: float) -> bool:
        return projected_ttft_s <= self.deadline_s(ctx)


POLICIES: dict[str, type[Policy]] = {
    RoundRobinPolicy.name: RoundRobinPolicy,
    LeastLoadedPolicy.name: LeastLoadedPolicy,
    NetworkAwarePolicy.name: NetworkAwarePolicy,
    PrefixAffinityPolicy.name: PrefixAffinityPolicy,
    SLOAwarePolicy.name: SLOAwarePolicy,
}


def make_policy(policy: str | Policy, **kwargs) -> Policy:
    """Resolve a policy name (or pass an instance through)."""
    if isinstance(policy, Policy):
        return policy
    try:
        cls = POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown policy {policy!r}; known: {sorted(POLICIES)}")
    return cls(**kwargs)
