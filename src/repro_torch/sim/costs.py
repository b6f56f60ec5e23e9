"""Calibrated cost models for the cluster simulator.

Two hardware profiles:

  * ``H100_NODE`` — the paper's environment (8×H100-80G per worker,
    400 Gbps NIC): used by the paper-figure reproductions so our numbers
    are commensurable with the paper's.
  * ``V5E_POD_SLICE`` — a 16-chip v5e slice per worker (197 TFLOP/s bf16,
    819 GB/s HBM, 50 GB/s ICI per link): the TPU deployment this repo
    targets; used by the TPU-flavored benchmarks.

Model-compute terms use the standard roofline forms:
  prefill(L)  = max(2·N·L / (peak·MFU_prefill), attn quadratic term)
  decode step = max((param_bytes + kv_bytes(batch)) / HBM_bw,
                    2·N·batch / peak)        — memory-bound at small batch
with MFU factors calibrated against the dry-run cost_analysis
(EXPERIMENTS.md §Roofline).  KV transfer costs come from
core.transfer_engine.LinkModel — the SAME timing model the engine itself
accrues, so the simulator and the mechanism layer cannot drift apart.

Copy of ``src/repro/sim/costs.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.transfer_engine import KVDIRECT_UTIL, LinkModel
from repro_torch.models.config import ModelConfig

__all__ = ["HardwareProfile", "H100_NODE", "V5E_POD_SLICE", "CostModel"]


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # per worker, bf16
    hbm_bw: float              # per worker aggregate, B/s
    hbm_bytes: int             # per worker TOTAL HBM (weights come out of this)
    link: LinkModel
    mfu_prefill: float = 0.55
    mfu_decode: float = 0.90   # fraction of HBM bw achieved in decode
    activation_headroom: float = 0.10


H100_NODE = HardwareProfile(
    name="8xH100",
    peak_flops=8 * 989e12,
    hbm_bw=8 * 3.35e12,
    hbm_bytes=8 * 80 * 2**30,
    link=LinkModel.nic_400g(),
)

V5E_POD_SLICE = HardwareProfile(
    name="16xv5e",
    peak_flops=16 * 197e12,
    hbm_bw=16 * 819e9,
    hbm_bytes=16 * 16 * 2**30,
    link=LinkModel.ici(),
)


@dataclasses.dataclass
class CostModel:
    cfg: ModelConfig
    hw: HardwareProfile

    # ----------------------------------------------------------- compute
    def prefill_s(self, prompt_len: int) -> float:
        n = self.cfg.active_param_count()
        flops = 2.0 * n * prompt_len
        if self.cfg.has_attention:
            flops += 2.0 * prompt_len * prompt_len * self.cfg.attn_dim
        return flops / (self.hw.peak_flops * self.hw.mfu_prefill)

    def decode_step_s(self, active_tokens: int, batch: int) -> float:
        """One generation iteration for a continuous batch.

        memory term: every active request streams the params once
        (amortized over the batch) plus its own KV; compute term: 2·N per
        token."""
        n = self.cfg.active_param_count()
        param_bytes = 2.0 * self.cfg.param_count()
        kv_bytes = float(
            active_tokens * self.cfg.num_layers
            * self.cfg.kv_bytes_per_token_per_layer()
        )
        t_mem = (param_bytes + kv_bytes) / (self.hw.hbm_bw * self.hw.mfu_decode)
        t_flops = 2.0 * n * max(batch, 1) / (self.hw.peak_flops * self.hw.mfu_prefill)
        return max(t_mem, t_flops)

    # ------------------------------------------------------------ memory
    def kv_bytes_per_token(self) -> int:
        if self.cfg.has_attention:
            return self.cfg.num_layers * self.cfg.kv_bytes_per_token_per_layer()
        # SSM state: fixed per request; approximate per-token cost 0
        return 0

    def kv_capacity_tokens(self) -> int:
        """Tokens of KV a worker can hold: total HBM minus the bf16
        weights minus activation headroom.  For the paper's 123B model on
        8×80G this is ~0.8M tokens — the capacity wall behind
        Motivation #3 and the pull-vs-push gap."""
        per_tok = self.kv_bytes_per_token()
        if per_tok == 0:
            return 1 << 62
        weights = 2.0 * self.cfg.param_count()
        usable = self.hw.hbm_bytes * (1 - self.hw.activation_headroom) - weights
        if usable <= 0:
            raise ValueError(f"{self.cfg.name} does not fit {self.hw.name}")
        return int(usable / per_tok)

    # ---------------------------------------------------------- transfer
    # Bandwidth-utilization anchors measured by the paper:
    #   Fig. 4/15 — UCX (message-passing): 1.8 % of link at 4 KB blocks,
    #   capped at 13.6 % for ≥32 KB blocks; KVDirect: 22.23 GB/s of a
    #   400 Gbps link ≈ 44.5 %.  The engine microbenches reproduce the
    #   RATIO mechanistically; the simulator uses the paper's absolute
    #   utilizations so its latencies are commensurable with Figs. 13-17.
    KVDIRECT_UTIL = KVDIRECT_UTIL  # shared anchor (core.transfer_engine)
    MESSAGE_UTIL_4KB = 0.018
    MESSAGE_UTIL_CAP = 0.136

    def _message_util(self, span_bytes: float) -> float:
        return float(min(self.MESSAGE_UTIL_CAP,
                         self.MESSAGE_UTIL_4KB * (span_bytes / 4096.0)))

    def transfer_s(self, prompt_len: int, *, mode: str = "tensor_centric",
                   block_tokens: int = 32, coalesce_factor: float = 8.0) -> float:
        """KV-cache transfer time for one request.  ``coalesce_factor`` =
        average pages per RDMA op after §4.2 coalescing (measured by the
        engine); it scales the per-op posting overhead AND the effective
        message span."""
        bw = self.hw.link.bandwidth_Bps
        if not self.cfg.has_attention:
            # SSM: one contiguous state per layer — degenerate best case
            state_bytes = self.cfg.num_layers * 2 * self.cfg.ssm_inner * self.cfg.ssm_state
            return self.cfg.num_layers * self.hw.link.post_overhead_s + \
                state_bytes / (self.KVDIRECT_UTIL * bw)
        span = block_tokens * self.cfg.kv_bytes_per_token_per_layer() // 2  # one K or V span
        n_spans = -(-prompt_len // block_tokens) * self.cfg.num_layers * 2
        total_bytes = float(prompt_len * self.kv_bytes_per_token())
        if mode == "tensor_centric":
            n_ops = max(1, int(n_spans / coalesce_factor))
            return n_ops * self.hw.link.post_overhead_s + \
                total_bytes / (self.KVDIRECT_UTIL * bw)
        if mode == "message":
            return total_bytes / (self._message_util(span) * bw)
        raise ValueError(mode)

    def transfer_layer_tail_s(self, prompt_len: int, **kw) -> float:
        """Visible tail of a LAYER-STREAMED transfer: the consumer may
        start on layer 0 while layers 1..L-1 are still in flight, so the
        un-overlappable part is one layer's share.  Applies to paged KV
        and to per-layer SSM state alike (``pull_state``/``push_layer``
        both move one layer at a time) — the same tail the sim's push
        path has always modeled, now realized by the pull path's
        ``transfer_overlap="layerwise"`` consumer
        (``DecodeWorker(consume="layerwise")``)."""
        return self.transfer_s(prompt_len, **kw) / max(self.cfg.num_layers, 1)
