"""granite-moe-3b-a800m — MoE [hf:ibm-granite/granite-3.0-3b-a800m-base family].

32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, 40 experts
top-8.  Every layer is MoE.  Experts padded 40→48 for even sharding over
the 16-way data axis (padded experts get -inf router logits; asserted
unreachable in tests).

Copy of ``src/repro/configs/granite_moe_3b_a800m.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    fold_model_axis_into_dp=True,  # DP+EP deployment; see ModelConfig
)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    num_experts=5,        # deliberately non-multiple-of-16 like the parent's 40
    experts_per_token=2,
)
