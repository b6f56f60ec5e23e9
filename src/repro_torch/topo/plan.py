"""Placement planning over a heterogeneous cluster topology.

Helix formulates role assignment on a heterogeneous cluster as max-flow
over the topology graph and solves placement with a MILP.  We keep the
max-flow *objective* — it is the right way to combine the three
bottlenecks (prefill compute, decode KV capacity, cross-partition link
bandwidth) into one number — but replace the MILP with a greedy +
local-search heuristic, so there is no solver dependency and planning a
dozen-machine cluster takes milliseconds.

The flow network for a candidate placement (P = prefill set, D = decode
set), all capacities in requests/second:

    source ──(prefill rate of p)──▶ p ──(link p→d bw / KV bytes)──▶ d
                                          d ──(decode rate of d)──▶ sink

Max-flow through this graph is the cluster's sustainable request rate
under the placement: it is automatically ≤ aggregate prefill throughput,
≤ aggregate decode capacity, and ≤ what the inter-partition links can
carry — and it correctly charges a fast prefill machine that only has
slow paths to decode.  ``PlacementPlanner.plan`` maximizes it.

Rates derive from ``WorkloadShape``: reference-machine request costs
(seconds on the 8×H100 reference node) scaled by each machine's
capability ratios.  ``WorkloadShape.from_cost`` calibrates the reference
costs from a ``sim.costs.CostModel`` so the planner and the simulator
price the same workload identically.

Copy of ``src/repro/topo/plan.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

from repro_torch.core.transfer_engine import KVDIRECT_UTIL

from .spec import REF_FLOPS, REF_HBM_BPS, REF_VRAM, ClusterSpec, MachineSpec

__all__ = ["WorkloadShape", "Placement", "PlacementPlanner", "random_placement"]


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    """The request shape the planner sizes for, with reference-machine
    costs (defaults: 16K/512 requests of a ~123B dense model on the
    8×H100 reference node, matching the paper's headline workload)."""

    prompt_len: int = 16_384
    response_len: int = 512
    decode_batch: int = 8
    kv_bytes_per_token: int = 352 * 1024      # paper §5.1, Mistral-Large-123B
    prefill_s_ref: float = 1.0                # 16K prompt on the reference node
    decode_step_s_ref: float = 0.012          # one iteration at decode_batch
    cap_tokens_ref: int = 800_000             # KV capacity of the reference node

    @classmethod
    def from_cost(cls, cost, *, prompt_len: int = 16_384,
                  response_len: int = 512, decode_batch: int = 8) -> "WorkloadShape":
        """Calibrate reference costs from a simulator ``CostModel`` (the
        capability ratios rescale ``cost.hw`` to the reference node, so
        any profile works as the calibration source)."""
        mean_active = decode_batch * (prompt_len + response_len // 2)
        return cls(
            prompt_len=prompt_len,
            response_len=response_len,
            decode_batch=decode_batch,
            kv_bytes_per_token=cost.kv_bytes_per_token(),
            prefill_s_ref=cost.prefill_s(prompt_len)
            * (cost.hw.peak_flops / REF_FLOPS),
            decode_step_s_ref=cost.decode_step_s(mean_active, decode_batch)
            * (cost.hw.hbm_bw / REF_HBM_BPS),
            cap_tokens_ref=int(cost.kv_capacity_tokens()
                               * (REF_VRAM / cost.hw.hbm_bytes)),
        )

    @property
    def kv_bytes_per_request(self) -> float:
        return float(self.prompt_len * self.kv_bytes_per_token)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A role assignment: machine ids per role (sorted — worker ids bind
    positionally as p0..pN / d0..dM) plus the planner's score in req/s."""

    prefill: tuple[str, ...]
    decode: tuple[str, ...]
    score: float = 0.0

    def __post_init__(self):
        if not self.prefill or not self.decode:
            raise ValueError("a placement needs >=1 prefill and >=1 decode")
        if set(self.prefill) & set(self.decode):
            raise ValueError("a machine cannot hold both roles")
        object.__setattr__(self, "prefill", tuple(sorted(self.prefill)))
        object.__setattr__(self, "decode", tuple(sorted(self.decode)))


def _max_flow(caps: dict[tuple[str, str], float], source: str, sink: str) -> float:
    """Edmonds–Karp on a dict-of-edges graph; fine at cluster scale."""
    residual: dict[tuple[str, str], float] = {}
    adj: dict[str, set[str]] = {}
    for (u, v), c in caps.items():
        residual[(u, v)] = residual.get((u, v), 0.0) + c
        residual.setdefault((v, u), 0.0)
        adj.setdefault(u, set()).add(v)
        adj.setdefault(v, set()).add(u)
    flow = 0.0
    while True:
        parent: dict[str, str | None] = {source: None}
        queue = deque([source])
        while queue and sink not in parent:
            u = queue.popleft()
            for v in sorted(adj.get(u, ())):
                if v not in parent and residual.get((u, v), 0.0) > 1e-12:
                    parent[v] = u
                    queue.append(v)
        if sink not in parent:
            return flow
        path = []
        v = sink
        while parent[v] is not None:
            path.append((parent[v], v))
            v = parent[v]  # type: ignore[assignment]
        aug = min(residual[e] for e in path)
        for u, w in path:
            residual[(u, w)] -= aug
            residual[(w, u)] += aug
        flow += aug


@dataclasses.dataclass
class PlacementPlanner:
    """Greedy + local-search max-flow placement (no MILP dependency).

    ``plan`` seeds a greedy assignment (machines ranked by per-role
    rates), then hill-climbs over single-machine moves and role swaps
    until no strictly-improving step exists; a few seeded random restarts
    guard against poor local optima, which also guarantees the plan never
    scores below a same-seed random baseline.  Deterministic given
    (spec, seed).
    """

    shape: WorkloadShape = dataclasses.field(default_factory=WorkloadShape)
    restarts: int = 4
    max_steps: int = 200

    # ------------------------------------------------------- machine rates
    def prefill_rate(self, m: MachineSpec) -> float:
        """Sustained prefill throughput, requests/s."""
        return m.profile.peak_flops / (REF_FLOPS * self.shape.prefill_s_ref)

    def decode_rate(self, m: MachineSpec) -> float:
        """Sustained decode completion rate, requests/s: batch-limited
        compute rate capped by how many requests the machine's KV pool
        can hold concurrently (Little's law)."""
        s = self.shape
        step_s = s.decode_step_s_ref * (REF_HBM_BPS / m.profile.hbm_Bps)
        cap_tokens = s.cap_tokens_ref * (m.profile.vram_bytes / REF_VRAM)
        resident = min(float(s.decode_batch),
                       cap_tokens / max(s.prompt_len + s.response_len, 1))
        if resident < 1.0:
            return 0.0  # cannot hold even one request's KV
        return resident / (s.response_len * step_s)

    # ------------------------------------------------------------- scoring
    def score(self, spec: ClusterSpec, prefill, decode) -> float:
        """Max-flow request rate of the candidate role split."""
        prefill, decode = set(prefill), set(decode)
        if not prefill or not decode or (prefill & decode):
            return 0.0
        per_req = self.shape.kv_bytes_per_request
        caps: dict[tuple[str, str], float] = {}
        for pid in prefill:
            caps[("source", pid)] = self.prefill_rate(spec.machine(pid))
        for did in decode:
            caps[(did, "sink")] = self.decode_rate(spec.machine(did))
        for pid in prefill:
            for did in decode:
                bw = spec.link(pid, did).bandwidth_Bps * KVDIRECT_UTIL
                caps[(pid, did)] = math.inf if per_req <= 0 else bw / per_req
        return _max_flow(caps, "source", "sink")

    def score_placement(self, spec: ClusterSpec, placement: Placement) -> float:
        return self.score(spec, placement.prefill, placement.decode)

    # ------------------------------------------------------------ planning
    def plan(self, spec: ClusterSpec, *, seed: int = 0,
             n_prefill: int | None = None,
             n_decode: int | None = None) -> Placement:
        """Best placement found.  With ``n_prefill``/``n_decode`` pinned
        the plan uses exactly those counts (remaining machines are
        spares); otherwise every machine gets a role."""
        import numpy as np

        ids = sorted(spec.ids())
        n = len(ids)
        if n < 2:
            raise ValueError("placement needs >=2 machines")
        k_p, k_d = n_prefill, n_decode
        if k_p is None and k_d is not None:
            k_p = n - k_d
        if k_d is None and k_p is not None:
            k_d = n - k_p
        if k_p is not None:
            if k_p < 1 or k_d < 1 or k_p + k_d > n:
                raise ValueError(
                    f"cannot place {k_p}P+{k_d}D on {n} machines")

        rng = np.random.default_rng(seed)
        starts = [self._greedy_start(spec, ids, k_p, k_d)]
        for _ in range(self.restarts):
            perm = [ids[int(i)] for i in rng.permutation(n)]
            kp = k_p if k_p is not None else int(rng.integers(1, n))
            kd = k_d if k_d is not None else n - kp
            starts.append((perm[:kp], perm[kp:kp + kd]))

        best: tuple[float, tuple, tuple] | None = None
        for prefill, decode in starts:
            sc, p, d = self._local_search(spec, list(prefill), list(decode),
                                          pinned=k_p is not None)
            cand = (sc, tuple(sorted(p)), tuple(sorted(d)))
            if best is None or cand[0] > best[0] or \
                    (cand[0] == best[0] and cand[1:] < best[1:]):
                best = cand
        assert best is not None
        return Placement(prefill=best[1], decode=best[2], score=best[0])

    def _greedy_start(self, spec, ids, k_p, k_d):
        """Rank-based seed: best prefill-rate machines take the prefill
        role, best decode-rate machines take decode."""
        by_prefill = sorted(ids, key=lambda i: (-self.prefill_rate(spec.machine(i)), i))
        if k_p is None:
            # split all machines: try every prefix size, keep the best
            best = None
            for k in range(1, len(ids)):
                p, d = by_prefill[:k], by_prefill[k:]
                sc = self.score(spec, p, d)
                if best is None or sc > best[0]:
                    best = (sc, p, d)
            return best[1], best[2]
        rest = by_prefill[k_p:]
        by_decode = sorted(rest, key=lambda i: (-self.decode_rate(spec.machine(i)), i))
        return by_prefill[:k_p], by_decode[:k_d]

    def _local_search(self, spec, prefill: list, decode: list, *, pinned: bool):
        sc = self.score(spec, prefill, decode)
        spares = sorted(set(spec.ids()) - set(prefill) - set(decode))
        for _ in range(self.max_steps):
            best_step = None  # (score, kind, a, b)
            p_sorted, d_sorted = sorted(prefill), sorted(decode)

            def consider(kind, a, b, new_p, new_d):
                nonlocal best_step
                s2 = self.score(spec, new_p, new_d)
                if s2 > sc and (best_step is None or s2 > best_step[0]):
                    best_step = (s2, kind, a, b)

            for p in p_sorted:
                for d in d_sorted:  # swap roles of p and d
                    consider("swap", p, d,
                             [x for x in prefill if x != p] + [d],
                             [x for x in decode if x != d] + [p])
            for s in spares:
                for p in p_sorted:  # spare replaces a prefill machine
                    consider("sub_p", p, s,
                             [x for x in prefill if x != p] + [s], decode)
                for d in d_sorted:  # spare replaces a decode machine
                    consider("sub_d", d, s,
                             prefill, [x for x in decode if x != d] + [s])
            if not pinned:
                for p in p_sorted:  # demote prefill -> decode
                    if len(prefill) > 1:
                        consider("move_pd", p, p,
                                 [x for x in prefill if x != p], decode + [p])
                for d in d_sorted:  # promote decode -> prefill
                    if len(decode) > 1:
                        consider("move_dp", d, d,
                                 prefill + [d], [x for x in decode if x != d])
            if best_step is None:
                break
            sc, kind, a, b = best_step
            if kind == "swap":
                prefill = [x for x in prefill if x != a] + [b]
                decode = [x for x in decode if x != b] + [a]
            elif kind == "sub_p":
                prefill = [x for x in prefill if x != a] + [b]
                spares = sorted(set(spares) - {b} | {a})
            elif kind == "sub_d":
                decode = [x for x in decode if x != a] + [b]
                spares = sorted(set(spares) - {b} | {a})
            elif kind == "move_pd":
                prefill = [x for x in prefill if x != a]
                decode = decode + [a]
            else:  # move_dp
                prefill = prefill + [a]
                decode = [x for x in decode if x != a]
        return sc, prefill, decode


def random_placement(spec: ClusterSpec, seed: int = 0, *,
                     n_prefill: int | None = None,
                     n_decode: int | None = None,
                     planner: PlacementPlanner | None = None) -> Placement:
    """Uniform random role assignment (>=1 per role) — the equal-hardware
    baseline the planner must beat.  Scored when a planner is supplied."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = sorted(spec.ids())
    n = len(ids)
    if n < 2:
        raise ValueError("need >=2 machines")
    perm = [ids[int(i)] for i in rng.permutation(n)]
    k_p = n_prefill if n_prefill is not None else int(rng.integers(1, n))
    k_d = n_decode if n_decode is not None else n - k_p
    if k_p < 1 or k_d < 1 or k_p + k_d > n:
        raise ValueError(f"cannot place {k_p}P+{k_d}D on {n} machines")
    prefill, decode = perm[:k_p], perm[k_p:k_p + k_d]
    score = planner.score(spec, prefill, decode) if planner else 0.0
    return Placement(prefill=tuple(prefill), decode=tuple(decode), score=score)
