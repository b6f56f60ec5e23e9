"""Memory-pressure preemption — the decode-side governor.

Without it, a decode worker whose KV pool fills simply stops admitting:
queued requests wait (or park) behind residents that may run for
hundreds more steps.  The governor trades resident progress for queue
progress when — and only when — both hold:

  * the worker's pool occupancy is at or above ``preempt_high``, and
  * its oldest KV_QUEUED waiter cannot fit in free + evictable blocks.

Then a victim is chosen among the residents (``victim_policy``:
LIFO protects long-running work, FIFO protects fresh arrivals,
priority sheds the lowest SLO class first) and either

  * **swapped** — its full KV moves to the ``HostSwapPool`` and the
    token stream pauses; the governor restores it (oldest-swapped
    first, original worker preferred) once a worker has room AND no
    waiters of its own, and the stream resumes token-identically; or
  * **sacrificed** — its decode KV is dropped and the request replays
    through the serving layer's truncate-and-replay restart (cheaper
    than swap for short contexts; the KV is re-pulled on replay).

Anti-thrash: a request is preempted at most ``max_preemptions`` times,
and never again before it has produced at least one new token since its
last preemption — an oscillating pool degrades to park behavior instead
of livelocking.

The governor is policy only: all mechanism (page copies, tracer phases,
handle metrics, restart) lives in ``DisaggService.swap_out_request`` /
``swap_in_request`` / ``sacrifice_request``.

Copy of ``src/repro/fleet/preempt.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

from repro_torch.fleet.config import DEFAULT_CLASS_RANK
from repro_torch.serving.request import RequestState

__all__ = ["MemoryGovernor"]


class MemoryGovernor:
    def __init__(self, cfg, pool, *, metrics=None) -> None:
        self.cfg = cfg
        self.pool = pool  # HostSwapPool (swap mode; unused for sacrifice)
        self.metrics = metrics
        self._preemptions: dict[str, int] = {}     # rid -> times preempted
        self._decoded_at_preempt: dict[str, int] = {}

    # ------------------------------------------------------------- driver
    def step(self, svc, *, draining: set | frozenset = frozenset()) -> dict[str, int]:
        """One governor pass over the service: purge stale swap entries,
        resume what fits, preempt where pressure demands.  Returns action
        counts for the tick report."""
        self._purge(svc)
        counts = {"swapped_in": self._resume(svc, draining)}
        counts.update(self._relieve(svc, draining))
        return counts

    # -------------------------------------------------------------- purge
    def _purge(self, svc) -> None:
        """Drop swap entries whose request left the swapped state by any
        other path — finished, failed over (decode-worker death restarts
        it from prefill), or rejected.  An entry is live only while its
        request is still pending, still DECODING, and resident nowhere."""
        for rid in self.pool.ids():
            entry = svc.pending.get(rid)
            stale = (entry is None
                     or entry[0].state is not RequestState.DECODING
                     or any(rid in dw.resident or rid in dw.inflight
                            for dw in svc.decodes.values()))
            if stale:
                self.pool.pop(rid)
        for rid in list(self._preemptions):
            if rid not in svc.pending:
                self._preemptions.pop(rid, None)
                self._decoded_at_preempt.pop(rid, None)

    # ------------------------------------------------------------- resume
    def _resume(self, svc, draining) -> int:
        """Swap back every entry that fits somewhere, oldest-swapped
        first.  A worker with KV_QUEUED waiters of its own is skipped —
        resuming there would re-trigger the very pressure that caused
        the swap.  The original worker is preferred (its retained
        prefixes may still be warm); any other non-draining worker is
        legal (SwappedKV is worker-agnostic)."""
        resumed = 0
        for rid in self.pool.ids():
            entry = self.pool.get(rid)
            home = entry.req.decode_worker
            order = sorted(
                (wid for wid in svc.decodes if wid not in draining),
                key=lambda w: (w != home, svc.decodes[w].occupancy))
            for wid in order:
                if self._waiters(svc, wid):
                    continue
                if svc.swap_in_request(rid, wid):
                    resumed += 1
                    break
        return resumed

    # ------------------------------------------------------------ relieve
    @staticmethod
    def _waiters(svc, wid: str) -> list:
        """KV_QUEUED requests assigned to ``wid``, oldest first."""
        w = [req for req, _ in svc.pending.values()
             if req.state is RequestState.KV_QUEUED and req.decode_worker == wid]
        w.sort(key=lambda r: r.arrival_s)
        return w

    def _relieve(self, svc, draining) -> dict[str, int]:
        counts = {"swapped_out": 0, "sacrificed": 0}
        for wid, dw in list(svc.decodes.items()):
            if wid in draining:
                continue  # its waiters are being reassigned away
            waiters = self._waiters(svc, wid)
            if not waiters or dw.occupancy < self.cfg.preempt_high:
                continue
            head = waiters[0]
            need = -(-head.prompt_len // dw.block_size)
            while dw.pool.num_free + dw.evictable_blocks < need:
                victim = self._pick_victim(svc, dw)
                if victim is None:
                    break  # nobody eligible: degrade to park behavior
                decoded = self._decoded(svc, victim)
                if self.cfg.preempt == "swap":
                    if not svc.swap_out_request(victim):
                        break  # host pool full: park behavior
                    counts["swapped_out"] += 1
                else:
                    svc.sacrifice_request(victim)
                    counts["sacrificed"] += 1
                self._preemptions[victim] = self._preemptions.get(victim, 0) + 1
                self._decoded_at_preempt[victim] = decoded
        return counts

    @staticmethod
    def _decoded(svc, rid: str) -> int:
        h = svc.handles.get(rid)
        return len(h.tokens) if h is not None else 0

    def _pick_victim(self, svc, dw) -> str | None:
        """Choose among this worker's residents per ``victim_policy``,
        skipping anyone over the preemption cap or without progress since
        their last preemption (anti-thrash)."""
        eligible = []
        for i, rid in enumerate(dw.resident):  # insertion order = admission order
            if self._preemptions.get(rid, 0) >= self.cfg.max_preemptions:
                continue
            if rid in self._decoded_at_preempt and \
                    self._decoded(svc, rid) <= self._decoded_at_preempt[rid]:
                continue
            eligible.append((i, rid))
        if not eligible:
            return None
        policy = self.cfg.victim_policy
        if policy == "fifo":
            return eligible[0][1]
        if policy == "priority":
            def rank(item):
                req = dw.resident[item[1]].req
                # higher class rank (batch) preempted first; newest
                # breaks ties so interactive work keeps its momentum
                return (DEFAULT_CLASS_RANK.get(req.slo_class, 1), item[0])
            return max(eligible, key=rank)[1]
        return eligible[-1][1]  # lifo
