"""``repro_torch.fleet`` — elastic control plane above the request router.

Three cooperating pieces, one config (docs/fleet.md):

  * ``Autoscaler``          — grows/shrinks the prefill and decode fleets
    from the same ``LoadReport`` stream the router places on; shrink is
    drain-then-retire through the router's draining set and the
    scheduler's graceful-leave membership path;
  * ``MemoryGovernor``      — memory-pressure preemption: a decode worker
    near its KV budget swaps a victim to the ``HostSwapPool`` (resumes
    token-identically) or sacrifices it to truncate-and-replay, instead
    of letting queued work park;
  * ``AdmissionController`` — rejects (``KVBudgetExceeded``, typed, on
    the handle) or defers dispatch when projected decode-fleet KV
    occupancy exceeds a budget.

``FleetController`` composes them per service; ``DisaggService`` builds
one when given a ``FleetConfig`` and ``ServeLoop.tick()`` steps it.  The
same policy space (swap vs sacrifice × thresholds × victim order) is
mirrored in ``repro_torch.sim.ClusterSim`` so policy choices can be made in
simulation and carried to the real substrate (benchmarks/fig_elastic.py
checks the ranking agrees).

Copy of ``src/repro/fleet/__init__.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.fleet.admission import (
    AdmissionController,
    AdmissionDeferred,
    KVBudgetExceeded,
)
from repro_torch.fleet.autoscale import Autoscaler
from repro_torch.fleet.config import FleetConfig
from repro_torch.fleet.controller import FleetController
from repro_torch.fleet.hostmem import HostSwapPool
from repro_torch.fleet.preempt import MemoryGovernor

__all__ = [
    "AdmissionController",
    "AdmissionDeferred",
    "Autoscaler",
    "FleetConfig",
    "FleetController",
    "HostSwapPool",
    "KVBudgetExceeded",
    "MemoryGovernor",
]
