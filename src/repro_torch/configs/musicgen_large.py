"""musicgen-large [audio] — 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB; prefill input_specs() provides
precomputed frame embeddings; decode operates on EnCodec token ids."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    embeds_input=True,
)
