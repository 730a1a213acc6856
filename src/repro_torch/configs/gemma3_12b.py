"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global (window 1024), 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Runs long_500k: predominantly sliding-window attention (DESIGN.md §5)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,
    sliding_window=1024,
    global_every=6,  # every 6th layer global => 5:1 local:global
    rope_theta=1_000_000.0,
    scale_embed=True,
    tie_embeddings=True,
    subquadratic=True,
)
