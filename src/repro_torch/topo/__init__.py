"""Topology subsystem: heterogeneous cluster model, placement planning,
and per-pair link-cost wiring (docs/topology.md).

  * ``topo.spec``    — ``ClusterSpec`` (machines, directed links) and the
    seeded ``ClusterGenerator`` / ``generate_cluster`` presets.
  * ``topo.plan``    — ``PlacementPlanner``: greedy + local-search
    max-flow role assignment; ``random_placement`` baseline.
  * ``topo.binding`` — ``TopologyBinding``: worker-id ↔ machine map,
    router links, sim scales, topology-aware hot-add spare picks.

Copy of ``src/repro/topo/__init__.py`` with its imports renamed to ``repro_torch``.
"""
from .binding import NoSpareMachine, TopologyBinding
from .plan import Placement, PlacementPlanner, WorkloadShape, random_placement
from .spec import (
    PRESETS,
    PROFILES,
    ClusterGenerator,
    ClusterSpec,
    Link,
    MachineProfile,
    MachineSpec,
    generate_cluster,
)

__all__ = [
    "ClusterGenerator", "ClusterSpec", "Link", "MachineProfile",
    "MachineSpec", "NoSpareMachine", "PRESETS", "PROFILES", "Placement",
    "PlacementPlanner", "TopologyBinding", "WorkloadShape",
    "generate_cluster", "random_placement",
]
