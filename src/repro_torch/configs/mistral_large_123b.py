"""Mistral-Large-Instruct-2407 (123B) — the PAPER's evaluation model
(§5.1): dense GQA with 8 KV heads, randomized weights.

Public dims: 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
KV per token = 2·8·128·2B·88L = 352 KB — exactly the paper's stated
"352 KB of memory for the KV cache [per token]".  Used by the
paper-faithful benchmarks (Fig. 13-17 reproductions).

Copy of ``src/repro/configs/mistral_large_123b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
)
