"""Bind a placement to live worker ids, and wire it into the stack.

``TopologyBinding`` is the one object the serving substrate, the router
and the simulator all hold: it maps worker ids (``p0..``/``d0..``,
assigned positionally over the placement's sorted machine ids) to
machines, derives per-pair ``LinkModel``s for ``RequestRouter``, per-
machine capability scales for ``ClusterSim``, and — when the fleet layer
hot-adds a worker — picks WHICH spare machine to add topology-aware (the
spare whose addition maximizes the planner's max-flow score).

Copy of ``src/repro/topo/binding.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

from repro_torch.core.transfer_engine import LinkModel

from .plan import Placement, PlacementPlanner
from .spec import ClusterSpec, Link, MachineSpec

__all__ = ["NoSpareMachine", "TopologyBinding"]


class NoSpareMachine(RuntimeError):
    """Raised when a hot-add is requested but every machine in the
    cluster spec already holds a role."""


class TopologyBinding:
    def __init__(self, spec: ClusterSpec, placement: Placement, *,
                 planner: PlacementPlanner | None = None):
        self.spec = spec
        self.placement = placement
        self.planner = planner
        self._wid_to_mid: dict[str, str] = {}
        for i, mid in enumerate(placement.prefill):
            self._wid_to_mid[f"p{i}"] = mid
        for i, mid in enumerate(placement.decode):
            self._wid_to_mid[f"d{i}"] = mid
        assigned = set(self._wid_to_mid.values())
        self._spares = sorted(set(spec.ids()) - assigned)

    # ------------------------------------------------------------- lookups
    @property
    def n_prefill(self) -> int:
        return sum(1 for w in self._wid_to_mid if w.startswith("p"))

    @property
    def n_decode(self) -> int:
        return sum(1 for w in self._wid_to_mid if w.startswith("d"))

    @property
    def spares(self) -> tuple[str, ...]:
        return tuple(self._spares)

    def machine(self, wid: str) -> MachineSpec | None:
        mid = self._wid_to_mid.get(wid)
        return self.spec.machine(mid) if mid is not None else None

    def _require(self, wid: str) -> MachineSpec:
        m = self.machine(wid)
        if m is None:
            raise KeyError(f"worker {wid!r} not bound to any machine")
        return m

    def pair_link(self, pwid: str, dwid: str) -> Link:
        return self.spec.link(self._require(pwid).machine_id,
                              self._require(dwid).machine_id)

    def links(self) -> dict[tuple[str, str], LinkModel]:
        """Per-pair router topology map for every bound (prefill, decode)
        pair — the ``RequestRouter(links=...)`` argument."""
        pids = sorted(w for w in self._wid_to_mid if w.startswith("p"))
        dids = sorted(w for w in self._wid_to_mid if w.startswith("d"))
        return {(p, d): self.pair_link(p, d).to_link_model()
                for p in pids for d in dids}

    # ------------------------------------------------- simulator interface
    # ClusterSim stays calibrated against a single reference CostModel and
    # applies the topology as RELATIVE scales; the caller supplies the
    # reference machine's numbers (cost.hw.*) so sim and plan agree.
    def prefill_slowdown(self, wid: str, ref_flops: float) -> float:
        return ref_flops / self._require(wid).profile.peak_flops

    def decode_slowdown(self, wid: str, ref_hbm_Bps: float) -> float:
        return ref_hbm_Bps / self._require(wid).profile.hbm_Bps

    def cap_scale(self, wid: str, ref_vram_bytes: float) -> float:
        return self._require(wid).profile.vram_bytes / ref_vram_bytes

    def pair_scale(self, pwid: str, dwid: str, ref_bandwidth_Bps: float) -> float:
        return ref_bandwidth_Bps / self.pair_link(pwid, dwid).bandwidth_Bps

    def pair_latency_s(self, pwid: str, dwid: str) -> float:
        return self.pair_link(pwid, dwid).latency_s

    # ----------------------------------------------------------- hot adds
    def has_spare(self, role: str) -> bool:
        return bool(self._spares)

    def pick_spare(self, role: str) -> str:
        """Which spare machine a hot-add of ``role`` should claim: the
        one whose addition maximizes the planner's max-flow score (ties
        broken by id).  Falls back to capability rank without a planner."""
        if not self._spares:
            raise NoSpareMachine(
                f"no spare machine in {self.spec.name!r} for a {role} add")
        if self.planner is not None:
            p_mids = sorted(self._wid_to_mid[w] for w in self._wid_to_mid
                            if w.startswith("p"))
            d_mids = sorted(self._wid_to_mid[w] for w in self._wid_to_mid
                            if w.startswith("d"))
            best = None
            for mid in self._spares:
                if role == "prefill":
                    sc = self.planner.score(self.spec, p_mids + [mid], d_mids)
                else:
                    sc = self.planner.score(self.spec, p_mids, d_mids + [mid])
                if best is None or sc > best[0]:
                    best = (sc, mid)
            return best[1]
        key = (lambda mid: (-self.spec.machine(mid).profile.peak_flops, mid)) \
            if role == "prefill" else \
            (lambda mid: (-self.spec.machine(mid).profile.vram_bytes, mid))
        return sorted(self._spares, key=key)[0]

    def add_worker(self, role: str, wid: str) -> MachineSpec:
        """Consume the best spare for ``role`` and bind it to ``wid``.
        Raises ``NoSpareMachine`` when the cluster is fully assigned."""
        if wid in self._wid_to_mid:
            raise ValueError(f"worker {wid!r} already bound")
        mid = self.pick_spare(role)
        self._spares.remove(mid)
        self._wid_to_mid[wid] = mid
        return self.spec.machine(mid)

    def release_worker(self, wid: str) -> None:
        """Return ``wid``'s machine to the spare pool (drain-then-retire)."""
        mid = self._wid_to_mid.pop(wid, None)
        if mid is not None:
            self._spares = sorted(set(self._spares) | {mid})
