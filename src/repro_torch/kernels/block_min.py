"""Per-block min + leftmost argmin (build phase, level 1): wrapper and plain version.

``block_min`` launches the CUDA kernel of ``csrc/block_min.cu`` for a CUDA
tensor and runs ``block_min_plain`` for a CPU tensor. The kernel replaces the
Pallas TPU kernel ``block_min`` (src/repro/kernels/block_min.py); its source
note gives its bound (one read of the blocks: about 81 us at n = 2^26
float32 on an H100) and design (one warp per row, leftmost shuffle min).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core.block_rmq import kernel_leftmost_min

from . import _build

__all__ = ["block_min", "block_min_plain"]

_ENTRY = {torch.float32: "repro_block_min_f32", torch.int32: "repro_block_min_i32"}
_count_lock = threading.Lock()


def block_min_plain(x_blocks: torch.Tensor):
    """The Pallas kernel's arithmetic in PyTorch: ``vmin = min(x)`` per row
    (-0.0 below +0.0, as ``jnp.min``), the lane as
    ``min(where(x == vmin, iota, bs))`` (``core.block_rmq.kernel_leftmost_min``)."""
    return kernel_leftmost_min(x_blocks)


def block_min(x_blocks: torch.Tensor, *, tile_rows: int = 8):
    """Per-block (min value, leftmost local argmin int32). x_blocks: (nb, bs).

    ``tile_rows`` rows (one warp each) share a thread block on the card.
    """
    if x_blocks.ndim != 2 or x_blocks.shape[1] % 128 != 0:
        raise ValueError(
            f"x_blocks must be (nb, bs) with bs % 128 == 0, got {tuple(x_blocks.shape)}"
        )
    if x_blocks.dtype not in _ENTRY:
        raise TypeError(f"block_min takes float32 or int32, got {x_blocks.dtype}")
    if x_blocks.device.type == "cpu":
        return block_min_plain(x_blocks)
    if x_blocks.device.type != "cuda":
        raise ValueError(f"block_min runs on cuda or cpu tensors, got {x_blocks.device}")
    if not x_blocks.is_contiguous():
        raise ValueError("block_min needs a contiguous x_blocks")
    if not 1 <= tile_rows <= 32:
        raise ValueError(f"tile_rows must be in [1, 32], got {tile_rows}")
    nb, bs = x_blocks.shape
    val = torch.empty(nb, dtype=x_blocks.dtype, device=x_blocks.device)
    idx = torch.empty(nb, dtype=torch.int32, device=x_blocks.device)
    if nb == 0:
        return val, idx
    _build.launch(
        _ENTRY[x_blocks.dtype], "block_min", x_blocks.device,
        x_blocks.data_ptr(), val.data_ptr(), idx.data_ptr(), nb, bs, tile_rows,
    )
    with _count_lock:
        block_min.launches += 1
    return val, idx


block_min.launches = 0  # kernel launches since the last reset (plain calls do not count)
