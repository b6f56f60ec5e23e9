"""whisper-large-v3 — encoder-decoder audio backbone [arXiv:2212.04356].

32L d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866.  32 encoder +
32 decoder layers; the conv/mel frontend is a STUB per the assignment —
input_specs() provides precomputed frame embeddings [b, 1500, d].
GELU MLP + LayerNorm + biases, per the original architecture.

Copy of ``src/repro/configs/whisper_large_v3.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,           # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_type="gelu",
    is_encoder_decoder=True,
    tie_embeddings=True,
    max_positions=65536,     # sized for the assigned decode_32k cell
)

SMOKE = ModelConfig(
    name="whisper-large-v3-smoke",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    encoder_seq=64,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    mlp_type="gelu",
    is_encoder_decoder=True,
    tie_embeddings=True,
    max_positions=256,
)
