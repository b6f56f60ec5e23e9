"""granite-34b — dense code LLM [arXiv:2405.04324; hf:ibm-granite/granite-34b-code-base].

88L d_model=6144 48H (GQA kv=1, i.e. MQA) d_ff=24576 vocab=49152.
GPT-BigCode lineage ⇒ 2-matrix GELU MLP (that is what makes the listed
dims total ~34B; a SwiGLU MLP at d_ff=24576 would be ~48B).

Copy of ``src/repro/configs/granite_34b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    mlp_type="gelu",
)
