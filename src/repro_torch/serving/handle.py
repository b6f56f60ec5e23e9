"""Per-request serving handles — the caller-facing half of the streaming
serving API.

``DisaggService.submit()`` returns a ``RequestHandle`` immediately; the
request then moves through the serving pipeline as ``ServeLoop.tick()``
(or one of the ``generate``/``generate_many`` shims driving it) makes
progress.  The handle exposes:

  * a coarse caller-facing status machine —

        QUEUED -> PREFILLING -> TRANSFERRING -> DECODING -> DONE
                                                         \\-> FAILED

    projected from the finer internal ``RequestState`` (KV_QUEUED /
    KV_TRANSFER / QUEUED_DECODE all read as TRANSFERRING: the caller
    sees "my KV is on the move", not the engine's bookkeeping).  FAILED
    is terminal only until ``DisaggService.retry_parked`` revives the
    request — a parked handle resumes streaming where capacity returns;

  * an incremental token stream — ``next_tokens()`` returns tokens
    produced since the last call, and iterating the handle drives the
    service loop until the request finishes (true streaming: tokens
    yield as decode steps land, not when the batch returns);

  * per-request service metrics (``HandleMetrics``): wall-clock TTFT,
    mean per-token latency, KV bytes actually pulled through the
    transfer engine (retries included), retry count, hedge outcome.

Failover note: a restart-from-prefill replays decode from scratch, so
the handle truncates its decoded tokens back to the first token and the
replay re-produces the identical stream (decode is deterministic).  A
consumer iterating across a failover may therefore observe a token
at-least-once; ``tokens`` itself never contains duplicates.

Copy of ``src/repro/serving/handle.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Iterator

from repro_torch.serving.request import Request, RequestState

__all__ = ["HandleStatus", "HandleMetrics", "RequestHandle"]


class HandleStatus(enum.Enum):
    QUEUED = "queued"              # submitted, prefill not dispatched yet
    PREFILLING = "prefilling"
    TRANSFERRING = "transferring"  # prefill done, KV queued / on the wire
    DECODING = "decoding"
    DONE = "done"
    FAILED = "failed"              # rejected, or parked by failover


_STATUS_OF: dict[RequestState, HandleStatus] = {
    RequestState.QUEUED_PREFILL: HandleStatus.QUEUED,
    RequestState.PREFILLING: HandleStatus.PREFILLING,
    RequestState.KV_QUEUED: HandleStatus.TRANSFERRING,
    RequestState.KV_TRANSFER: HandleStatus.TRANSFERRING,
    RequestState.QUEUED_DECODE: HandleStatus.TRANSFERRING,
    RequestState.DECODING: HandleStatus.DECODING,
    RequestState.DONE: HandleStatus.DONE,
    RequestState.FAILED: HandleStatus.FAILED,
}


@dataclasses.dataclass
class HandleMetrics:
    """Wall-clock service metrics for one request (monotonic seconds)."""

    submitted_at: float
    first_token_at: float | None = None
    last_token_at: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    kv_bytes_pulled: int = 0   # bytes landed decode-side, retries included
    kv_bytes_reused: int = 0   # bytes a delta plan skipped (resident graft)
    hedged: bool = False       # a prefill twin was dispatched
    hedge_adopted: bool = False  # failover switched to the twin's KV
    swapped_out: int = 0       # preempted to host memory (resumed later)
    sacrificed: int = 0        # preempted by drop + truncate-and-replay

    @property
    def kv_reuse_frac(self) -> float:
        """Fraction of this request's KV served from resident blocks
        instead of the wire (0.0 when nothing was reused)."""
        total = self.kv_bytes_pulled + self.kv_bytes_reused
        return self.kv_bytes_reused / total if total else 0.0

    @property
    def ttft_s(self) -> float | None:
        """Submit → first token (wall clock)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def ttlt_s(self) -> float | None:
        """Submit → last token so far (time-to-last-token once DONE)."""
        if self.last_token_at is None:
            return None
        return self.last_token_at - self.submitted_at

    @property
    def tbt_s(self) -> float | None:
        """Mean per-token latency after the first token."""
        if len(self.token_times) < 2:
            return None
        gaps = [b - a for a, b in zip(self.token_times, self.token_times[1:])]
        return sum(gaps) / len(gaps)


class RequestHandle:
    """Caller-side view of one submitted request.

    Unknown attributes delegate to the underlying ``Request`` (``state``,
    ``prefill_worker``, ``retries``, ...), so existing callers that held
    a ``Request`` keep working unchanged.
    """

    def __init__(self, request: Request, service, *,
                 max_new: int | None = None, eos_token: int | None = None,
                 hedge: int = 1, clock=None) -> None:
        self.request = request
        self.service = service
        self.max_new = max_new      # decode-token budget (None = until EOS)
        self.eos_token = eos_token
        self.hedge = hedge
        self.tokens: list[int] = []  # [first_token, *decoded]
        self.error: Exception | None = None
        # One clock for every per-request timestamp: the service passes
        # its observability clock so handle metrics, tracer spans, and
        # the span-derived breakdown are mutually consistent (a sim can
        # inject a virtual clock and get the same schema).
        self._clock = clock or time.monotonic
        self.metrics = HandleMetrics(submitted_at=self._clock())
        self._consumed = 0

    # ------------------------------------------------------------ status
    @property
    def request_id(self) -> str:
        return self.request.request_id

    @property
    def status(self) -> HandleStatus:
        return _STATUS_OF[self.request.state]

    @property
    def done(self) -> bool:
        return self.request.state is RequestState.DONE

    @property
    def failed(self) -> bool:
        return self.request.state is RequestState.FAILED

    @property
    def finished(self) -> bool:
        """Terminal for now: DONE, or FAILED (parked — revivable)."""
        return self.request.state in (RequestState.DONE, RequestState.FAILED)

    @property
    def decoded(self) -> int:
        """Decode tokens produced so far (excludes the prefill token)."""
        return max(0, len(self.tokens) - 1)

    def decode_finished(self) -> bool:
        """Budget reached or EOS produced — the loop retires us next.
        The prefill-produced first token counts: a stream whose very
        first token is EOS terminates without a decode step."""
        if self.eos_token is not None and self.tokens \
                and self.tokens[-1] == self.eos_token:
            return True
        return self.max_new is not None and self.decoded >= self.max_new

    # ------------------------------------------------------------ stream
    def next_tokens(self) -> list[int]:
        """Tokens produced since the last call (non-blocking)."""
        new = self.tokens[self._consumed:]
        self._consumed = len(self.tokens)
        return list(new)

    def _raise_failed(self) -> None:
        if self.error is not None:
            raise self.error  # terminal (e.g. AdmissionRejected at dispatch)
        raise RuntimeError(
            f"{self.request_id} is parked after failover (no capacity); "
            "add workers / free capacity and call retry_parked()")

    def __iter__(self) -> Iterator[int]:
        """Stream tokens, driving the service loop between yields.
        Raises (like ``result``) if the request fails — a truncated
        stream must not look like a completed one."""
        i = 0
        while True:
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self.done:
                return
            if self.failed:
                self._raise_failed()
            self.service.loop.advance(self)
            i = min(i, len(self.tokens))  # failover truncation: re-stream

    def result(self) -> list[int]:
        """Drive the loop until this request finishes; the full token
        list (first token included).  Raises the rejection error for a
        terminally rejected request, or RuntimeError for one parked by
        failover (revivable via ``retry_parked``)."""
        if not self.finished:
            self.service.loop.advance(self, until_done=True)
        if self.failed:
            self._raise_failed()
        return list(self.tokens)

    # ----------------------------------------------------- loop plumbing
    def _push(self, token: int, at: float | None = None) -> None:
        at = self._clock() if at is None else at
        self.tokens.append(token)
        if self.metrics.first_token_at is None:
            self.metrics.first_token_at = at
        self.metrics.last_token_at = at
        self.metrics.token_times.append(at)

    def _reset_decoded(self) -> None:
        """Failover restart: decode replays from scratch, so drop the
        decoded suffix (the replay regenerates the identical tokens)."""
        del self.tokens[1:]
        self._consumed = min(self._consumed, len(self.tokens))
        del self.metrics.token_times[1:]

    # ------------------------------------------------------- delegation
    def __getattr__(self, name: str):
        # only called when normal lookup fails: fall through to Request
        return getattr(self.request, name)

    def __repr__(self) -> str:
        return (f"RequestHandle({self.request_id!r}, {self.status.value}, "
                f"tokens={len(self.tokens)})")
