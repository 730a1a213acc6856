"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240,
ssm_state=64 — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242; hf]

Shared attention: ONE attention+FFN param set applied after every 6 Mamba2
layers (9 applications over 54 layers). Runs long_500k (hybrid/SSM)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    attn_every=6,
    tie_embeddings=True,
    subquadratic=True,
)
