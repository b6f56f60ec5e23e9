"""llava-next-mistral-7b — VLM, anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Mistral-7B backbone: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.  The vision tower + anyres tiling is a STUB per the
assignment: input_specs() provides precomputed patch embeddings
[b, 2880, d] (5 tiles × 576 patches — the anyres 2×2+base grid), which
the model early-fuses ahead of the text tokens.  Long multimodal
prompts make VLM serving a best case for KVDirect (image-token KV
dominates the transfer).

Copy of ``src/repro/configs/llava_next_mistral_7b.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    vision_tokens=2880,     # 5 anyres tiles x 576 patches
)

SMOKE = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    vision_tokens=32,
)
