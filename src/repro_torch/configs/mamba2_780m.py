"""mamba2-780m — attention-free SSD [arXiv:2405.21060; hf:state-spaces/mamba2-780m].

48L d_model=1536 vocab=50280, ssm_state=128.  expand=2 ⇒ d_inner=3072,
head_dim=64 ⇒ 48 SSD heads, conv kernel 4, tied embeddings (that's the
780M total).  No attention ⇒ the transferable decode state is the fixed
size (ssd_state, conv_tail) pair per layer — KVDirect's degenerate best
case (one contiguous read per layer), and long_500k RUNS (O(1) state).

Copy of ``src/repro/configs/mamba2_780m.py`` with its imports renamed to ``repro_torch``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    tie_embeddings=True,
)
