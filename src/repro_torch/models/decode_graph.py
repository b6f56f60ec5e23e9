"""The paged decode step replayed as CUDA graphs, captured piecewise around
its paged attention calls.

A decode step issued op by op keeps the card waiting on the host: dozens
of small launches a layer.  ``DecoderLM.decode_piece`` cuts the step at
its L paged attention calls into L + 1 pieces; each piece is captured once
per padded batch size as a CUDA graph and replayed every step.  Between
two pieces the host runs, eagerly, what the graphs cannot hold: the new
token's K/V written into the state's pages and the paged_attention kernel
over them (``DecoderLM.paged_attend``, the same call as the eager step's),
which writes its output into the next piece's static input.  The KV state
stays the caller's: rebuilt on a join, a leave or an exhausted margin, it
needs no new capture, since no piece reads a page.

Batches are padded up to the next of ``BUCKETS``, pad rows after the real
ones with token 0 and context 0; the attention runs on the real rows
alone.  The rows of the dense pieces are independent.  An MoE piece's rows
share one routing group (``models.moe``, below 512 tokens), where the pad
pairs come after the real ones in the buffer order and change nothing
unless a pair can be dropped: where ``capacity_factor * k < E`` the graphs
are keyed by the exact batch instead.  The graphs of every bucket are
captured together at the first step that needs one (one warm-up run each,
on the capture stream, then the capture, in one memory pool), so that a
server captures them while it warms up; exact batches are captured as
they come.

Off the card (a model on the CPU, in tests) nothing is captured: the
pieces run eagerly where the graphs would replay them, their outputs
copied into the same static buffers.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch

__all__ = ["BUCKETS", "DecodeGraphs"]

BUCKETS = (1, 2, 4, 8, 16, 24, 32)


@dataclasses.dataclass
class _Pieces:
    """The static inputs and outputs of one batch size's pieces."""

    tok: torch.Tensor              # [n] int32 the step's tokens, pad rows 0
    pos: torch.Tensor              # [n] int32 the contexts before the step, pad rows 0
    a: torch.Tensor                # [n, heads, hd] the last attention's output
    outs: list = dataclasses.field(default_factory=list)    # piece i's outputs
    graphs: list = dataclasses.field(default_factory=list)  # piece i's CUDA graph
    rows: int = 0                  # the real rows of the last step
    views: list = dataclasses.field(default_factory=list)   # their a, then q, k, v a piece

    def real(self, b: int) -> list:
        """The ``[:b]`` views of ``a`` and of each piece's q, k and v, kept
        while the batch keeps ``b`` rows; pad rows zeroed when it shrinks."""
        if b != self.rows:
            if b < self.rows:
                self.tok[b:].zero_()
                self.pos[b:].zero_()
            self.rows = b
            self.views = [self.a[:b]] + [tuple(t[:b] for t in out[1:])
                                         for out in self.outs[:-1]]
        return self.views


class DecodeGraphs:
    """The pieces of ``model``'s paged decode step on ``params``, captured
    per batch size (``key``).  ``step`` runs one decode step through them."""

    def __init__(self, model, params):
        # a proxy: the model keeps its runner (``decode_graphs``), and a cycle
        # would keep both, and the weights, until a full collection
        self.model, self.params = weakref.proxy(model), params
        self.capture = model.device.type == "cuda"
        cfg = model.cfg
        # the layers' weights as views, kept: the graphs read their addresses
        self.layers = list(model._sublayers(params))
        self.exact = (cfg.family == "moe"
                      and cfg.capacity_factor * cfg.experts_per_token < cfg.num_experts)
        self.sets: dict[int, _Pieces] = {}
        self._pool = self._stream = None

    def key(self, b: int) -> int:
        """The batch size whose graphs run ``b`` sequences."""
        return b if self.exact else next(n for n in BUCKETS if n >= b)

    def engages(self, state) -> bool:
        """Paged KV on one device (``DecoderLM.paged_decode``) and at most
        ``BUCKETS[-1]`` sequences."""
        return self.model.paged_decode(state) and state.context_lens.shape[0] <= BUCKETS[-1]

    def step(self, state, tokens):
        """One decode step -> (tokens int32 [b], the new state, ``"capture"``
        when this step captured graphs, else ``"replay"``).  The state's
        pages are written in place, as ``decode_step`` writes them."""
        b = state.context_lens.shape[0]
        n = self.key(b)
        mode = "replay"
        with torch.no_grad():
            if n not in self.sets:
                for m in (BUCKETS if not self.exact else (n,)):
                    self.sets[m] = self._build(m)
                mode = "capture"
            s = self.sets[n]
            a, *qkv = s.real(b)
            s.tok[:b].copy_(tokens)
            s.pos[:b].copy_(state.context_lens)
            attend, ctx = self.model.paged_attend(state)
            self._run(s, 0)
            for i, (q, k, v) in enumerate(qkv):
                attend(i, q, k, v, out=a)
                self._run(s, i + 1)
            tokens = s.outs[-1][1][:b].clone()
        return tokens, dataclasses.replace(state, context_lens=ctx), mode

    def _piece(self, s: _Pieces, i: int):
        """Piece i as read from ``s``: the inputs are the static buffers and
        piece i-1's outputs, looked up when it runs (in a capture, the
        captured outputs)."""
        x = s.tok if i == 0 else s.outs[i - 1][0]
        return self.model.decode_piece(self.params, self.layers, i, x, s.a, s.pos,
                                       greedy=i == len(self.layers))

    def _run(self, s: _Pieces, i: int) -> None:
        if self.capture:
            s.graphs[i].replay()
        else:
            for out, got in zip(s.outs[i], self._piece(s, i)):
                out.copy_(got)

    def _build(self, n: int) -> _Pieces:
        """The static buffers of batch size ``n``, and on the card its
        captured graphs, each replayed once so that the next piece's
        warm-up reads finite values."""
        cfg, dev = self.model.cfg, self.model.device
        dtype = torch.promote_types(self.params["embed"]["table"].dtype,
                                    self.layers[0][1]["attn"]["q"]["w"].dtype)
        s = _Pieces(tok=torch.zeros(n, dtype=torch.int32, device=dev),
                    pos=torch.zeros(n, dtype=torch.int32, device=dev),
                    a=torch.zeros((n, cfg.num_heads, cfg.head_dim), dtype=dtype, device=dev))
        pieces = len(self.layers) + 1
        if not self.capture:
            for i in range(pieces):
                s.outs.append(self._piece(s, i))
            return s
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self._stream):
            for i in range(pieces):
                self._piece(s, i)                     # warm-up
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=self._pool, capture_error_mode="thread_local")
                try:
                    out = self._piece(s, i)
                finally:
                    g.capture_end()
                g.replay()
                s.outs.append(out)
                s.graphs.append(g)
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        return s
