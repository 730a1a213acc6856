"""Modality frontend STUBS for [vlm]/[audio] architectures.

Port of ``repro/models/frontends.py``: these entries specify the
transformer backbone only; the modality frontend provides precomputed
patch/frame embeddings. ``synthetic_embeddings`` draws them from a seeded
``torch.Generator`` (so they differ from the reference's JAX PRNG draws);
``embedding_spec`` is their shape and dtype on ``meta``.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve

__all__ = ["synthetic_embeddings", "embedding_spec"]


def synthetic_embeddings(cfg, batch: int, seq_len: int, seed: int = 0, *, device=None) -> torch.Tensor:
    """Stand-in for InternViT patch embeddings / EnCodec frame embeddings."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, seq_len, cfg.d_model), generator=gen, dtype=torch.float32, device=dev)
    return x.to(cfg.dtype)


def embedding_spec(cfg, batch: int, seq_len: int) -> torch.Tensor:
    return torch.empty((batch, seq_len, cfg.d_model), dtype=cfg.dtype, device="meta")
