"""yi-9b — dense llama-arch GQA [arXiv:2403.04652; hf:01-ai/Yi-9B].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Copy of ``src/repro/configs/yi_9b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=1,
    d_ff=192,
    vocab_size=512,
)
