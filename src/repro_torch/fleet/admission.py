"""KV-budget admission control.

The SLO policy (``sched.policies.SLOAwarePolicy``) rejects on projected
*latency*; this controller rejects on projected *memory*: a request is
only dispatched while the decode fleet's projected KV occupancy —
blocks in use, minus lazily-reclaimable prefix cache, plus everything
already queued, plus this request's own footprint — stays under a
budget fraction.  Past the budget a new request would only deepen the
queue the memory governor then has to preempt its way out of, so the
cheapest intervention point is the front door.

``KVBudgetExceeded`` subclasses ``sched.AdmissionRejected`` so every
existing "rejected at dispatch" code path (handle ``error``, queued
rejection, eager-submit raise) handles it unchanged; ``AdmissionDeferred``
is the soft variant — the serving loop leaves the request QUEUED_PREFILL
and retries next tick.

Copy of ``src/repro/fleet/admission.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

from repro_torch.sched import AdmissionRejected

__all__ = ["KVBudgetExceeded", "AdmissionDeferred", "AdmissionController"]


class KVBudgetExceeded(AdmissionRejected):
    """Typed rejection: projected decode-fleet KV occupancy over budget.

    Surfaces on the ``RequestHandle`` (FAILED, ``error`` set) for queued
    dispatch, or raises from ``submit()`` for eager dispatch — exactly
    the SLO rejection's contract.
    """

    def __init__(self, request_id: str, projected_frac: float,
                 budget_frac: float) -> None:
        # Skip AdmissionRejected.__init__ (its message is TTFT-shaped).
        RuntimeError.__init__(
            self,
            f"{request_id}: projected decode KV occupancy "
            f"{projected_frac:.2f} exceeds admission budget "
            f"{budget_frac:.2f}")
        self.request_id = request_id
        self.projected_frac = projected_frac
        self.budget_frac = budget_frac


class AdmissionDeferred(RuntimeError):
    """Soft admission verdict: not now, try again next tick.  Never
    surfaces to the caller — the serving loop swallows it and leaves the
    request queued."""

    def __init__(self, request_id: str, projected_frac: float,
                 budget_frac: float) -> None:
        super().__init__(
            f"{request_id}: deferred at projected occupancy "
            f"{projected_frac:.2f} (budget {budget_frac:.2f})")
        self.request_id = request_id
        self.projected_frac = projected_frac
        self.budget_frac = budget_frac


class AdmissionController:
    def __init__(self, budget_frac: float, *, mode: str = "reject",
                 metrics=None) -> None:
        if not 0.0 < budget_frac <= 1.0:
            raise ValueError(f"budget_frac must be in (0, 1], got {budget_frac}")
        if mode not in ("reject", "defer"):
            raise ValueError(f"mode must be reject|defer, got {mode!r}")
        self.budget_frac = budget_frac
        self.mode = mode
        self.metrics = metrics

    def projected_fraction(self, reports, need_blocks: int) -> float:
        """Decode-fleet occupancy if ``need_blocks`` more were admitted.

        ``reports`` is the decode-role LoadReport map; evictable prefix
        blocks count as spendable (the worker reclaims them on demand),
        queued-but-unpulled footprint counts as committed.
        """
        total = used = 0
        for rep in reports.values():
            if rep is None:
                continue
            total += rep.total_blocks
            used += (rep.total_blocks - rep.free_blocks
                     - rep.evictable_blocks + rep.queued_blocks)
        if total <= 0:
            return 1.0  # no capacity visible: everything is over budget
        return (used + need_blocks) / total

    def check(self, reports, need_blocks: int, request_id: str) -> None:
        """Raise ``KVBudgetExceeded`` / ``AdmissionDeferred`` when the
        projection lands over budget; silently pass otherwise."""
        projected = self.projected_fraction(reports, need_blocks)
        if projected <= self.budget_frac:
            return
        if self.metrics is not None:
            self.metrics.inc("fleet.admission_rejected"
                             if self.mode == "reject"
                             else "fleet.admission_deferred")
        cls = KVBudgetExceeded if self.mode == "reject" else AdmissionDeferred
        raise cls(request_id, projected, self.budget_frac)
