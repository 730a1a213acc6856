"""mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]

Runs long_500k: O(1) state per token (sub-quadratic by construction)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,  # padded to 50432
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    tie_embeddings=True,
    subquadratic=True,
)
