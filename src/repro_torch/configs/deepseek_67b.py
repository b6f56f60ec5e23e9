"""deepseek-67b — dense llama-arch [arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.  SwiGLU/RMSNorm/RoPE.

Copy of ``src/repro/configs/deepseek_67b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
)
