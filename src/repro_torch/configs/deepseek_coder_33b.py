"""deepseek-coder-33b — dense llama-arch code model [arXiv:2401.14196;
hf:deepseek-ai/deepseek-coder-33b-base].

62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.

Copy of ``src/repro/configs/deepseek_coder_33b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
)

SMOKE = ModelConfig(
    name="deepseek-coder-33b-smoke",
    family="dense",
    num_layers=2,
    d_model=56,          # keeps the 56-head:8-kv ratio shape-odd like the parent
    num_heads=7,
    num_kv_heads=1,
    d_ff=160,
    vocab_size=512,
    head_dim=8,
)
