"""hymba-1.5b — hybrid parallel attention+SSM heads [arXiv:2411.13676;
hf:nvidia/Hymba-1.5B-Base].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Each layer runs attention and a Mamba-2 SSD head bank IN PARALLEL on the
same input and fuses the branch outputs (per-branch RMSNorm, mean), as
in the paper.  Sliding-window attention (1024) + 128 learnable meta
tokens (always visible) keep decode state O(1) ⇒ long_500k RUNS.
head_dim=64 (1600/25); SSM: expand=2 ⇒ d_inner=3200, 50 SSD heads.

Copy of ``src/repro/configs/hymba_1p5b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    sliding_window=1024,
    num_meta_tokens=128,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    ssm_state=8,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    sliding_window=32,
    num_meta_tokens=8,
    tie_embeddings=True,
)
