"""llama4-maverick-400b-a17b — interleaved MoE, early fusion
[hf:meta-llama/Llama-4-Maverick-17B-128E].

48L d_model=5120 40H (GQA kv=8) vocab=202048, MoE 128 experts top-1.
Llama-4 interleaves: every 2nd layer is MoE (128 routed experts top-1 +
one always-on shared expert, d_ff=8192); the other layers are dense with
d_ff=16384.  That interleave is exactly what makes the listed dims total
~400B with ~17B active — all-MoE at these dims would be ~780B.
bf16 optimizer moments (fp32_master=False) so the train_4k state fits a
v5e pod (see DESIGN.md).

Copy of ``src/repro/configs/llama4_maverick_400b_a17b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,              # per-expert width
    d_ff_dense=16384,       # interleaved dense layers
    vocab_size=202048,
    num_experts=128,
    experts_per_token=1,
    moe_shared_expert=True,
    moe_every=2,
    fp32_master=False,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    d_ff_dense=128,
    vocab_size=512,
    num_experts=8,
    experts_per_token=1,
    moe_shared_expert=True,
    moe_every=2,
)
