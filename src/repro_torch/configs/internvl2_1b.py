"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2/Qwen2 backbone. [arXiv:2404.16821; hf]

Backbone only: the InternViT frontend is a STUB; input_specs() provides
precomputed patch embeddings (repro_torch.models.frontends)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,  # padded to 151808
    qkv_bias=True,
    tie_embeddings=True,
    embeds_input=True,
    attn_shard="seq",  # 14 heads don't divide the 16-wide model axis
)
