"""Plain PyTorch oracles for the CUDA kernels (kernel checks assert against these)."""

from __future__ import annotations

import torch

__all__ = ["block_min_ref"]


def block_min_ref(x_blocks: torch.Tensor):
    """Per-block (min value, leftmost local argmin int32).

    ``torch.argmin`` returns the first minimal index, as ``jnp.argmin`` does
    in the reference oracle; the kernels themselves never rely on it.
    """
    lidx = torch.argmin(x_blocks, dim=1)
    val = x_blocks.gather(1, lidx[:, None])[:, 0]
    return val, lidx.to(torch.int32)
