"""Heterogeneous cluster topology: machine profiles, per-pair links.

KVDirect's premise is that fast KV transfer makes *distributed*
disaggregation viable — but "distributed" clusters are rarely uniform.
Helix (ASPLOS'25) models a heterogeneous, possibly geo-distributed GPU
cluster as a directed graph of typed machines and per-pair links, then
plans over that graph.  This module is our version of the cluster half:

  * ``MachineProfile``  — a machine *type* (peak FLOPs, VRAM, NIC Gbps).
  * ``MachineSpec``     — one concrete machine: id + profile + region.
  * ``Link``            — one DIRECTED edge: bandwidth, propagation
                          latency, and a tier tag (rack / region /
                          cross_region).  Directed because real paths
                          are asymmetric (different return routes,
                          asymmetric provisioning); the router prices
                          each direction separately.
  * ``ClusterSpec``     — machines + links, validated, with a stable
                          JSON round-trip so the SAME spec drives the
                          simulator and the real serving substrate
                          byte-for-byte.
  * ``ClusterGenerator``— Helix-style seeded synthesizer of reproducible
                          heterogeneous / geo-distributed clusters.

Everything here is pure data + numpy; planning lives in ``topo.plan``
and wiring into the serving/sim layers in ``topo.binding``.

Copy of ``src/repro/topo/spec.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core.transfer_engine import LinkModel

__all__ = [
    "MachineProfile", "MachineSpec", "Link", "ClusterSpec",
    "ClusterGenerator", "PROFILES", "PRESETS", "generate_cluster",
]

# Reference machine for relative scaling: the paper's 8×H100-80G node
# with a 400 Gbps NIC (sim.costs.H100_NODE uses the same numbers).
REF_FLOPS = 8 * 989e12
REF_HBM_BPS = 8 * 3.35e12
REF_VRAM = 8 * 80 * 2**30
REF_NIC_GBPS = 400.0


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """A machine *type*: the three capability axes the planner scores on
    (compute → prefill rate, VRAM → decode KV capacity, NIC → attachable
    link bandwidth) plus HBM bandwidth for the decode-step roofline."""

    name: str
    peak_flops: float        # aggregate bf16 FLOP/s
    vram_bytes: int          # aggregate accelerator memory
    nic_gbps: float          # NIC line rate, Gbit/s
    hbm_Bps: float = 0.0     # aggregate HBM bandwidth; 0 → derived

    def __post_init__(self):
        if self.peak_flops <= 0 or self.vram_bytes <= 0 or self.nic_gbps <= 0:
            raise ValueError(f"non-positive capability in profile {self.name!r}")
        if self.hbm_Bps <= 0:
            # H100-like compute:HBM ratio keeps derived profiles on the
            # same roofline shape as the reference node.
            object.__setattr__(self, "hbm_Bps",
                               self.peak_flops * (REF_HBM_BPS / REF_FLOPS))

    @property
    def nic_Bps(self) -> float:
        return self.nic_gbps * 1e9 / 8.0


# A small catalog spanning ~8× in compute and ~3× in VRAM — enough
# heterogeneity that role assignment matters.  Names are host shapes,
# not marketing SKUs.
PROFILES: dict[str, MachineProfile] = {
    "8xh100": MachineProfile("8xh100", peak_flops=REF_FLOPS,
                             vram_bytes=REF_VRAM, nic_gbps=400.0,
                             hbm_Bps=REF_HBM_BPS),
    "8xa100": MachineProfile("8xa100", peak_flops=8 * 312e12,
                             vram_bytes=8 * 40 * 2**30, nic_gbps=200.0,
                             hbm_Bps=8 * 2.0e12),
    "4xa100": MachineProfile("4xa100", peak_flops=4 * 312e12,
                             vram_bytes=4 * 40 * 2**30, nic_gbps=100.0,
                             hbm_Bps=4 * 2.0e12),
    "8xl4": MachineProfile("8xl4", peak_flops=8 * 121e12,
                           vram_bytes=8 * 24 * 2**30, nic_gbps=100.0,
                           hbm_Bps=8 * 300e9),
    "16xv5e": MachineProfile("16xv5e", peak_flops=16 * 197e12,
                             vram_bytes=16 * 16 * 2**30, nic_gbps=400.0,
                             hbm_Bps=16 * 819e9),
}


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """One concrete machine in a cluster."""

    machine_id: str
    profile: MachineProfile
    region: str = "r0"


# Per-op posting overhead by tier: rack-local links behave like the
# engine's default NIC; cross-region paths pay a DCN-ish per-op cost.
_TIER_POST_OVERHEAD_S = {"rack": 2e-6, "region": 2e-6, "cross_region": 3e-6}
_TIERS = tuple(_TIER_POST_OVERHEAD_S)


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed src→dst path."""

    src: str
    dst: str
    bandwidth_Bps: float
    latency_s: float = 0.0
    tier: str = "rack"

    def __post_init__(self):
        if self.src == self.dst:
            raise ValueError(f"self-link {self.src!r}")
        if self.bandwidth_Bps <= 0:
            raise ValueError(f"non-positive bandwidth on {self.src}->{self.dst}")
        if self.latency_s < 0:
            raise ValueError(f"negative latency on {self.src}->{self.dst}")
        if self.tier not in _TIERS:
            raise ValueError(f"unknown tier {self.tier!r} (want one of {_TIERS})")

    def to_link_model(self) -> LinkModel:
        """The transfer-engine/router view of this path: same timing
        fields the engine accrues, so routing and mechanism agree."""
        return LinkModel(bandwidth_Bps=self.bandwidth_Bps,
                         post_overhead_s=_TIER_POST_OVERHEAD_S[self.tier],
                         latency_s=self.latency_s)


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Machines + directed links, validated at construction.

    ``links`` need not be complete: ``link(a, b)`` falls back to a
    rack-tier path at the slower endpoint's NIC rate, so a spec may list
    only the pairs that deviate from "NIC-limited, same rack".
    """

    name: str
    machines: tuple[MachineSpec, ...]
    links: tuple[Link, ...] = ()
    seed: int | None = None

    def __post_init__(self):
        ids = [m.machine_id for m in self.machines]
        if not ids:
            raise ValueError("empty cluster")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate machine ids in {self.name!r}")
        known = set(ids)
        seen: set[tuple[str, str]] = set()
        for lk in self.links:
            if lk.src not in known or lk.dst not in known:
                raise ValueError(
                    f"link {lk.src}->{lk.dst} references unknown machine "
                    f"(known: {sorted(known)})")
            if (lk.src, lk.dst) in seen:
                raise ValueError(f"duplicate link {lk.src}->{lk.dst}")
            seen.add((lk.src, lk.dst))

    # ------------------------------------------------------------ lookups
    def ids(self) -> tuple[str, ...]:
        return tuple(m.machine_id for m in self.machines)

    def machine(self, machine_id: str) -> MachineSpec:
        for m in self.machines:
            if m.machine_id == machine_id:
                return m
        raise KeyError(machine_id)

    def link(self, src: str, dst: str) -> Link:
        for lk in self.links:
            if lk.src == src and lk.dst == dst:
                return lk
        # NIC-limited rack-local default for unlisted pairs.
        bw = min(self.machine(src).profile.nic_Bps,
                 self.machine(dst).profile.nic_Bps)
        return Link(src, dst, bandwidth_Bps=bw)

    @property
    def max_vram(self) -> int:
        return max(m.profile.vram_bytes for m in self.machines)

    @property
    def max_flops(self) -> float:
        return max(m.profile.peak_flops for m in self.machines)

    # --------------------------------------------------------- round-trip
    def to_json(self) -> str:
        """Stable serialization — the byte-for-byte artifact that the sim
        and the real service both consume (and that tests diff)."""
        return json.dumps({
            "name": self.name,
            "seed": self.seed,
            "machines": [
                {"machine_id": m.machine_id, "region": m.region,
                 "profile": dataclasses.asdict(m.profile)}
                for m in self.machines
            ],
            "links": [dataclasses.asdict(lk) for lk in self.links],
        }, sort_keys=True, indent=1)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        d = json.loads(text)
        machines = tuple(
            MachineSpec(m["machine_id"], MachineProfile(**m["profile"]),
                        region=m.get("region", "r0"))
            for m in d["machines"])
        links = tuple(Link(**lk) for lk in d.get("links", []))
        return cls(name=d["name"], machines=machines, links=links,
                   seed=d.get("seed"))


@dataclasses.dataclass(frozen=True)
class ClusterGenerator:
    """Seeded synthesizer of heterogeneous / geo-distributed clusters,
    after Helix's FakeClusterGenerator: same seed → identical spec.

    Machines draw a profile from ``profile_mix`` (name → weight) and are
    dealt round-robin into ``n_regions`` regions.  Every ordered pair
    gets a directed link: intra-region pairs sample from the ``intra_*``
    ranges, cross-region pairs from the much slower/laggier ``cross_*``
    ranges.  Each direction samples independently (``asymmetric=True``),
    so A→B cheap / B→A expensive arises naturally.  Link bandwidth is
    always capped by the slower endpoint's NIC.
    """

    name: str = "generated"
    n_machines: int = 6
    n_regions: int = 1
    profile_mix: tuple[tuple[str, float], ...] = (
        ("8xh100", 1.0), ("8xa100", 1.0), ("8xl4", 1.0))
    intra_bw_gbps: tuple[float, float] = (100.0, 400.0)
    intra_latency_s: tuple[float, float] = (0.0, 50e-6)
    cross_bw_gbps: tuple[float, float] = (10.0, 40.0)
    cross_latency_s: tuple[float, float] = (10e-3, 40e-3)
    asymmetric: bool = True

    def __post_init__(self):
        if self.n_machines < 2:
            raise ValueError("need at least 2 machines")
        if self.n_regions < 1 or self.n_regions > self.n_machines:
            raise ValueError(f"n_regions {self.n_regions} out of range")
        for name, w in self.profile_mix:
            if name not in PROFILES:
                raise ValueError(f"unknown profile {name!r}")
            if w < 0:
                raise ValueError(f"negative weight for {name!r}")

    def generate(self, seed: int = 0) -> ClusterSpec:
        rng = np.random.default_rng(seed)
        names = [n for n, _ in self.profile_mix]
        weights = np.array([w for _, w in self.profile_mix], dtype=float)
        weights = weights / weights.sum()
        picks = rng.choice(len(names), size=self.n_machines, p=weights)
        machines = tuple(
            MachineSpec(f"m{i}", PROFILES[names[int(picks[i])]],
                        region=f"r{i % self.n_regions}")
            for i in range(self.n_machines))

        def sample(lo_hi: tuple[float, float]) -> float:
            lo, hi = lo_hi
            return float(rng.uniform(lo, hi))

        links = []
        for a in machines:
            for b in machines:
                if a.machine_id == b.machine_id:
                    continue
                # b->a reuses a->b's draws when symmetric: consume the
                # randomness only on the canonical direction.
                if not self.asymmetric and a.machine_id > b.machine_id:
                    fwd = next(lk for lk in links
                               if lk.src == b.machine_id and lk.dst == a.machine_id)
                    links.append(Link(a.machine_id, b.machine_id,
                                      bandwidth_Bps=fwd.bandwidth_Bps,
                                      latency_s=fwd.latency_s, tier=fwd.tier))
                    continue
                same_region = a.region == b.region
                bw_gbps = sample(self.intra_bw_gbps if same_region
                                 else self.cross_bw_gbps)
                lat = sample(self.intra_latency_s if same_region
                             else self.cross_latency_s)
                nic_cap = min(a.profile.nic_Bps, b.profile.nic_Bps)
                links.append(Link(
                    a.machine_id, b.machine_id,
                    bandwidth_Bps=min(bw_gbps * 1e9 / 8.0, nic_cap),
                    latency_s=lat,
                    tier="rack" if same_region else "cross_region"))
        return ClusterSpec(name=f"{self.name}-s{seed}", machines=machines,
                           links=tuple(links), seed=seed)


# Three reference shapes for the fig_topology sweep and tests: one
# heterogeneous rack, one 2-region geo split, one 3-region split with a
# skewed profile mix.  All reproducible from (preset, seed).
PRESETS: dict[str, ClusterGenerator] = {
    "hetero_rack": ClusterGenerator(
        name="hetero_rack", n_machines=6, n_regions=1,
        profile_mix=(("8xh100", 1.0), ("8xa100", 1.0), ("8xl4", 1.0))),
    "geo_pair": ClusterGenerator(
        name="geo_pair", n_machines=8, n_regions=2,
        profile_mix=(("8xh100", 1.0), ("8xa100", 2.0), ("4xa100", 1.0))),
    "geo_triad": ClusterGenerator(
        name="geo_triad", n_machines=9, n_regions=3,
        profile_mix=(("8xh100", 1.0), ("8xa100", 1.0),
                     ("8xl4", 1.0), ("16xv5e", 1.0))),
}


def generate_cluster(preset: str, seed: int = 0) -> ClusterSpec:
    """One shared cluster source for benchmarks and tests: Fig-12 cells
    and the topology sweep both call this, so they cannot drift."""
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r} (want one of {sorted(PRESETS)})")
    return PRESETS[preset].generate(seed)
