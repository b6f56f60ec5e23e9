"""Unified model configuration for every assigned architecture family.

One dataclass covers dense / MoE / enc-dec(audio) / VLM / SSM / hybrid so
that the serving engines, the launch steps, and the dry-run can treat all
ten architectures uniformly (``--arch <id>``).

Copy of ``src/repro/models/config.py`` with its imports renamed to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ModelConfig"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | ssm | hybrid
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0               # 0 for attention-free archs
    num_kv_heads: int = 0
    d_ff: int = 0                    # dense FFN width (per-expert width for MoE)
    head_dim: int = 0                # derived from d_model/num_heads if 0

    # --- MLP flavor ----------------------------------------------------
    mlp_type: str = "swiglu"         # "swiglu" (3-matrix) | "gelu" (2-matrix)

    # --- MoE ---------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False  # Llama-4-style always-on shared expert
    moe_every: int = 1               # MoE every k-th layer (Llama-4: 2)
    d_ff_dense: int = 0              # FFN width of interleaved dense layers
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 SSD) --------------------------------------------
    ssm_state: int = 0               # N (dstate)
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # --- encoder-decoder (whisper) -------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500          # precomputed frame embeddings (stub frontend)
    max_positions: int = 65536       # learned decoder position table (sized for
                                     # the assigned decode_32k shape; whisper
                                     # proper uses 448)

    # --- VLM (llava) ----------------------------------------------------
    vision_tokens: int = 0           # anyres patch tokens per image (stub frontend)

    # --- attention flavor ----------------------------------------------
    sliding_window: int = 0          # 0 = full attention
    num_meta_tokens: int = 0         # hymba learnable prefix
    rope_theta: float = 10_000.0

    # --- training -------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    fp32_master: bool = True         # False => bf16 optimizer moments (maverick)

    # --- deployment ------------------------------------------------------
    # True: fold the mesh 'model' axis into data parallelism (DP+EP, no
    # tensor parallelism for weights).  The right call for small-dim MoE
    # (granite-moe: d=1536, ff=512/expert — TP-16 shards are sub-MXU and
    # every activation gradient psums over an axis that shards nothing;
    # measured in EXPERIMENTS.md §Perf).  Sequence-parallel flash-decoding
    # still uses the 'model' axis for KV pages regardless.
    fold_model_axis_into_dp: bool = False

    # ------------------------------------------------------------ derived
    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def padded_experts(self) -> int:
        """Experts padded so the expert dim shards over the data axis (16)."""
        return _round_up(self.num_experts, 16) if self.num_experts else 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model if self.ssm_state else 0

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def is_subquadratic(self) -> bool:
        """True iff decode-state is O(1) in context (SSM / sliding window)
        — the gate for the long_500k shape (see DESIGN.md §4)."""
        attn_ok = (not self.has_attention) or self.sliding_window > 0
        return attn_ok

    # ------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Total parameters (unpadded vocab, real experts)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head

        mats = 3 if self.mlp_type == "swiglu" else 2

        def attn_params() -> int:
            return d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d

        def mlp_params(ff: int | None = None) -> int:
            return mats * d * (self.d_ff if ff is None else ff)

        def moe_params() -> int:
            per_expert = mats * d * self.d_ff
            shared = per_expert if self.moe_shared_expert else 0
            return d * self.num_experts + self.num_experts * per_expert + shared

        def ssm_params() -> int:
            di, ns, nh = self.ssm_inner, self.ssm_state, self.ssm_heads
            # in_proj (x, z, B, C, dt) + conv + out_proj + A,D
            return (
                d * (2 * di + 2 * ns + nh)
                + self.ssm_conv * (di + 2 * ns)
                + di * d
                + 2 * nh
            )

        if self.family in ("dense", "vlm"):
            n += self.num_layers * (attn_params() + mlp_params())
        elif self.family == "moe":
            n_moe = self.num_layers // self.moe_every
            n_dense = self.num_layers - n_moe
            n += n_moe * (attn_params() + moe_params())
            n += n_dense * (attn_params() + mlp_params(self.d_ff_dense))
        elif self.family == "ssm":
            n += self.num_layers * ssm_params()
        elif self.family == "hybrid":
            n += self.num_layers * (attn_params() + ssm_params() + mlp_params())
        elif self.family == "audio":
            # decoder layers have self+cross attention
            n += self.num_layers * (2 * attn_params() + mlp_params())
            n += self.encoder_layers * (attn_params() + mlp_params())
        return n

    def active_param_count(self) -> int:
        """Active params per token (= N for dense; routed subset for MoE)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        mats = 3 if self.mlp_type == "swiglu" else 2
        per_expert = mats * d * self.d_ff
        attn = d * self.attn_dim + 2 * d * self.kv_dim + self.attn_dim * d
        active_moe = (self.experts_per_token + (1 if self.moe_shared_expert else 0)) * per_expert
        n_moe = self.num_layers // self.moe_every
        n_dense = self.num_layers - n_moe
        n = 2 * self.vocab_size * d
        n += n_moe * (attn + d * self.num_experts + active_moe)
        n += n_dense * (attn + mats * d * self.d_ff_dense)
        return n

    def model_flops(self, num_tokens: int) -> float:
        """MODEL_FLOPS = 6·N_active·D (§Roofline)."""
        return 6.0 * self.active_param_count() * num_tokens

    def kv_bytes_per_token_per_layer(self, itemsize: int = 2) -> int:
        if self.has_attention:
            return 2 * self.kv_dim * itemsize
        return 0

    def describe(self) -> str:
        n = self.param_count()
        return (
            f"{self.name}: {self.family}, {self.num_layers}L d={self.d_model} "
            f"H={self.num_heads}/{self.num_kv_heads} ff={self.d_ff} "
            f"vocab={self.vocab_size} params={n/1e9:.2f}B "
            f"(active {self.active_param_count()/1e9:.2f}B)"
        )
