"""Request lifecycle and per-request service metrics (TTFT / TBT / total).

Matches the paper's measurement definitions (§5.1): measured TTFT
*includes the waiting time for the KV cache*, TBT is the mean gap between
tokens after the first, total latency is arrival→last token.

Copy of ``src/repro/serving/request.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import enum

__all__ = ["RequestState", "Request"]


class RequestState(enum.Enum):
    QUEUED_PREFILL = "queued_prefill"
    PREFILLING = "prefilling"
    KV_QUEUED = "kv_queued"        # prefill done, waiting for decode-side blocks
    KV_TRANSFER = "kv_transfer"
    QUEUED_DECODE = "queued_decode"
    DECODING = "decoding"
    DONE = "done"
    FAILED = "failed"


# Legal transitions; anything else is a scheduler bug.
_TRANSITIONS: dict[RequestState, set[RequestState]] = {
    RequestState.QUEUED_PREFILL: {RequestState.PREFILLING, RequestState.FAILED},
    RequestState.PREFILLING: {RequestState.KV_QUEUED, RequestState.KV_TRANSFER, RequestState.FAILED},
    # KV_QUEUED -> DONE: stream complete before any pull (EOS produced
    # by prefill, or a zero decode budget); the prefill copy is released
    # by the serving layer since no COMPLETE will ever fire
    RequestState.KV_QUEUED: {RequestState.KV_TRANSFER, RequestState.QUEUED_PREFILL, RequestState.DONE, RequestState.FAILED},
    # KV_TRANSFER -> KV_QUEUED: hedged-prefill failover — the pull died
    # with its source but a hedge twin's KV copy survives, so the request
    # goes back to waiting for admission instead of re-prefilling
    RequestState.KV_TRANSFER: {RequestState.QUEUED_DECODE, RequestState.KV_QUEUED, RequestState.QUEUED_PREFILL, RequestState.FAILED},
    RequestState.QUEUED_DECODE: {RequestState.DECODING, RequestState.FAILED},
    RequestState.DECODING: {RequestState.DONE, RequestState.FAILED},
    RequestState.DONE: set(),
    # retry after worker failure: full re-prefill, or straight back to
    # KV_QUEUED when the prefill copy survived (decode-side failover)
    RequestState.FAILED: {RequestState.QUEUED_PREFILL, RequestState.KV_QUEUED},
}


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_len: int
    max_new_tokens: int
    arrival_s: float = 0.0
    slo_class: str = "standard"  # TTFT deadline class (sched.policies)
    # Shared-prefix identity for prefix-aware routing: requests carrying
    # the same prefix_id share their first prefix_len prompt tokens
    # (0 = the whole prompt).  Used by the "prefix_affinity" policy and
    # the decode workers' prefix retention cache.
    prefix_id: str | None = None
    prefix_len: int = 0

    state: RequestState = RequestState.QUEUED_PREFILL
    prefill_worker: str | None = None
    decode_worker: str | None = None
    connection_epoch: int | None = None
    prefill_blocks: list[int] = dataclasses.field(default_factory=list)
    decode_blocks: list[int] = dataclasses.field(default_factory=list)
    # Content hashes of the parked prefill KV, one per block position
    # (digest over the block's K+V bytes across ALL layers).  Byte
    # equality ⇒ identical prefix context, so decode workers dedup
    # transfer plans against any resident block with the same hash —
    # even across requests with no shared prefix_id.
    block_hashes: list[str] = dataclasses.field(default_factory=list)
    # Per-(layer, block position, plane) int8 dequant scales computed at
    # prefill park time — present only under quantized transfer; they
    # ride the ReadTxn descriptors (see core.descriptors.ReadTxn.qscale).
    kv_scales: list | None = None
    tokens_generated: int = 0
    retries: int = 0

    # -- timeline (absolute seconds on the serving clock) ---------------
    prefill_start_s: float | None = None
    prefill_end_s: float | None = None
    transfer_start_s: float | None = None
    transfer_end_s: float | None = None
    decode_start_s: float | None = None
    token_times_s: list[float] = dataclasses.field(default_factory=list)
    done_s: float | None = None

    def to(self, new: RequestState) -> None:
        if new not in _TRANSITIONS[self.state]:
            raise ValueError(f"{self.request_id}: illegal transition {self.state} -> {new}")
        self.state = new

    # -- metrics ---------------------------------------------------------
    @property
    def ttft_s(self) -> float | None:
        """Arrival → first token; includes KV-cache wait (paper §5.1)."""
        if not self.token_times_s:
            return None
        return self.token_times_s[0] - self.arrival_s

    @property
    def tbt_s(self) -> float | None:
        if len(self.token_times_s) < 2:
            return None
        gaps = [b - a for a, b in zip(self.token_times_s, self.token_times_s[1:])]
        return sum(gaps) / len(gaps)

    @property
    def total_latency_s(self) -> float | None:
        if self.done_s is None:
            return None
        return self.done_s - self.arrival_s

    def breakdown(self) -> dict[str, float]:
        """Fig. 14 segments: prefill queue / prefill / transfer / decode
        queue / decode."""
        def span(a: float | None, b: float | None) -> float:
            return (b - a) if (a is not None and b is not None) else 0.0

        return {
            "prefill_queue_s": span(self.arrival_s, self.prefill_start_s),
            "prefill_s": span(self.prefill_start_s, self.prefill_end_s),
            "transfer_s": span(self.transfer_start_s, self.transfer_end_s)
            + span(self.prefill_end_s, self.transfer_start_s),  # KV alloc wait folded in
            "decode_queue_s": span(self.transfer_end_s, self.decode_start_s),
            "decode_s": span(self.decode_start_s, self.done_s),
        }
