"""Load-driven fleet sizing (P/D-Serve-style dynamic P/D ratio).

The autoscaler watches the same ``LoadReport`` stream the router places
on (no second telemetry channel) and emits *decisions*, not side
effects: ``plan()`` returns a list of actions —

    ("add", role)            grow the role by one hot-added worker
    ("drain", role, wid)     stop routing to ``wid``; retire when empty

— which ``FleetController`` applies through the existing membership path
(``DisaggService.add_*_worker`` / router draining / scheduler removal).
Keeping the policy pure makes it trivially testable and lets the
discrete-event simulator run the IDENTICAL decision code against
synthetic load.

Signals:
  * decode pressure   — mean decode ``load_fraction`` (in-use + queued
    demand over capacity: rising backlog shows up before pools fill);
  * prefill pressure  — mean prefill ``load_fraction``, plus the
    dispatch backlog (QUEUED_PREFILL requests nobody routed yet) spread
    over the prefill fleet.

Hysteresis: a role must hold pressure above ``scale_up`` (or below
``scale_down``) for ``patience`` consecutive evaluations before any
action fires, and a role with a drain still in progress is left alone —
otherwise a bursty arrival process whipsaws the fleet.

Equal-peak-hardware mode (``total_cap``): when the fleet is at its cap,
growing one role first requires draining the other — the autoscaler
shifts the P/D *ratio* instead of adding hardware, which is the regime
benchmarks/fig_elastic.py scores (static vs autoscaled at the same peak
worker count).

Copy of ``src/repro/fleet/autoscale.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

__all__ = ["Autoscaler"]


def _mean_load(reports) -> float:
    fracs = [rep.load_fraction for rep in reports.values() if rep is not None]
    return sum(fracs) / len(fracs) if fracs else 0.0


class Autoscaler:
    def __init__(self, cfg, *, metrics=None) -> None:
        self.cfg = cfg
        self.metrics = metrics
        # consecutive over-/under-pressure counts per role
        self._hot = {"prefill": 0, "decode": 0}
        self._cold = {"prefill": 0, "decode": 0}

    # ------------------------------------------------------------ signals
    def pressures(self, prefill_reports, decode_reports,
                  dispatch_backlog: int) -> dict[str, float]:
        n_p = max(len(prefill_reports), 1)
        backlog_frac = dispatch_backlog / n_p  # queued requests per worker
        return {
            "prefill": _mean_load(prefill_reports) + backlog_frac,
            "decode": _mean_load(decode_reports),
        }

    # ------------------------------------------------------------- limits
    def _bounds(self, role: str) -> tuple[int, int]:
        c = self.cfg
        return ((c.min_prefill, c.max_prefill) if role == "prefill"
                else (c.min_decode, c.max_decode))

    # --------------------------------------------------------------- plan
    def plan(self, prefill_reports, decode_reports, *,
             dispatch_backlog: int = 0,
             draining: dict[str, str] | None = None) -> list[tuple]:
        """One evaluation: update hysteresis counters, return actions.

        ``draining`` maps worker_id -> role for drains already in
        flight; a role that is mid-drain neither grows nor shrinks
        (its capacity is already changing).
        """
        cfg = self.cfg
        draining = draining or {}
        drain_roles = set(draining.values())
        sizes = {"prefill": len(prefill_reports), "decode": len(decode_reports)}
        pressures = self.pressures(prefill_reports, decode_reports,
                                   dispatch_backlog)
        actions: list[tuple] = []
        for role in ("prefill", "decode"):
            p = pressures[role]
            self._hot[role] = self._hot[role] + 1 if p >= cfg.scale_up else 0
            self._cold[role] = self._cold[role] + 1 if p <= cfg.scale_down else 0
            if role in drain_roles:
                continue  # capacity already in motion
            lo, hi = self._bounds(role)
            other = "decode" if role == "prefill" else "prefill"
            if self._hot[role] >= cfg.patience and sizes[role] < hi:
                total = sizes["prefill"] + sizes["decode"]
                if cfg.total_cap is not None and total >= cfg.total_cap:
                    # at peak hardware: shift the ratio — drain the
                    # other role's least useful worker to make room
                    o_lo, _ = self._bounds(other)
                    if sizes[other] > o_lo and other not in drain_roles:
                        victim = self._least_loaded(
                            prefill_reports if other == "prefill"
                            else decode_reports, draining)
                        if victim is not None:
                            actions.append(("drain", other, victim))
                            actions.append(("add", role))
                            self._hot[role] = 0
                else:
                    actions.append(("add", role))
                    self._hot[role] = 0
            elif self._cold[role] >= cfg.patience and sizes[role] > lo:
                reports = (prefill_reports if role == "prefill"
                           else decode_reports)
                victim = self._least_loaded(reports, draining)
                if victim is not None:
                    actions.append(("drain", role, victim))
                    self._cold[role] = 0
        if actions and self.metrics is not None:
            for act in actions:
                self.metrics.inc(f"fleet.autoscale_{act[0]}_{act[1]}")
        return actions

    @staticmethod
    def _least_loaded(reports, draining) -> str | None:
        """Drain victim: the least-loaded worker not already draining —
        fewest residents to wait out, least routed traffic to shed."""
        candidates = [(rep.load_fraction, wid)
                      for wid, rep in reports.items()
                      if rep is not None and wid not in draining]
        if not candidates:
            return None
        return min(candidates)[1]
