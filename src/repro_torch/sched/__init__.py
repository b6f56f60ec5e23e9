"""Load- and network-aware request scheduling (the layer §4.2/§4.3 enable).

KVDirect's pull-based transfer and dynamic membership exist so a fleet of
prefill and decode workers can be scheduled flexibly; this package is the
scheduler that exercises that flexibility:

  * ``load``     — ``LoadReport`` telemetry piggybacked on the cluster
    heartbeat (no second control channel);
  * ``policies`` — pluggable placement policies (round-robin,
    least-loaded, KV-locality/network-aware, SLO-aware admission);
  * ``router``   — ``RequestRouter``: owns request queues, routes each
    request to a (prefill, decode) pair, projects TTFT for admission,
    and re-routes on worker failure.

The same policy objects drive both the real serving layer
(``repro_torch.serving.disagg``) and the discrete-event simulator
(``repro_torch.sim.events``), so policy experiments in the simulator transfer
directly to the live service.

Copy of ``src/repro/sched/__init__.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.sched.load import LoadReport, modeled_transfer_s
from repro_torch.sched.policies import (
    DEFAULT_SLO_CLASSES,
    Candidate,
    LeastLoadedPolicy,
    NetworkAwarePolicy,
    Policy,
    PrefixAffinityPolicy,
    RoundRobinPolicy,
    RouteRequest,
    SLOAwarePolicy,
    make_policy,
)
from repro_torch.sched.router import (
    AdmissionRejected,
    NoWorkersError,
    RequestRouter,
    RouteDecision,
)

__all__ = [
    "AdmissionRejected",
    "Candidate",
    "DEFAULT_SLO_CLASSES",
    "LeastLoadedPolicy",
    "LoadReport",
    "NetworkAwarePolicy",
    "NoWorkersError",
    "Policy",
    "PrefixAffinityPolicy",
    "RequestRouter",
    "RoundRobinPolicy",
    "RouteDecision",
    "RouteRequest",
    "SLOAwarePolicy",
    "make_policy",
    "modeled_transfer_s",
]
