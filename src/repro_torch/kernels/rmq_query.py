"""Partial-block candidates of a query batch: wrapper and plain version.

``rmq_partials`` launches the CUDA kernel of ``csrc/rmq_partials.cu`` for
CUDA tensors and runs ``rmq_partials_plain`` for CPU tensors. The kernel
replaces the Pallas TPU kernel ``rmq_partials`` (src/repro/kernels/
rmq_query.py): the left partial ``x_blocks[bl, lstart..lend]`` and the right
partial ``x_blocks[br, 0..rend]`` (masked off unless ``br > bl``), merged
left-first. It is the first pass of ``ops.query(fused=False)``, whose
interior and final merge stay in PyTorch. The source note of the kernel
gives its bound and design.
"""

from __future__ import annotations

import threading

import torch

from repro_torch._device import as_index
from repro_torch.core.block_rmq import kernel_leftmost_min, maxval, signed_min

from . import _build
from .tuning import DEFAULT_TILE, MAX_TILE

__all__ = ["rmq_partials", "rmq_partials_plain", "DEFAULT_TILE"]

_ENTRY = {torch.float32: "repro_rmq_partials_f32", torch.int32: "repro_rmq_partials_i32"}
_count_lock = threading.Lock()


def rmq_partials_plain(x_blocks, bl, br, lstart, lend, rend):
    """The reference kernel's arithmetic (rmq_query.py:55-72): masked-iota
    leftmost min of each side (``kernel_leftmost_min``), the right side set
    to maxval unless ``br > bl``, ``lv <= rv`` keeps the left. A lane
    outside a side's range never wins a tie, so a maxval-only range answers
    with its first index (the repair of ROADMAP.md §3). Returns (value,
    global idx)."""
    bs = x_blocks.shape[1]
    big = maxval(x_blocks.dtype)
    lanes = torch.arange(bs, dtype=torch.int32, device=x_blocks.device)[None, :]

    inside_l = (lanes >= lstart[:, None]) & (lanes <= lend[:, None])
    lv, li = kernel_leftmost_min(x_blocks[bl], inside_l)
    lg = bl * bs + li

    # The right lane is the one the reference finds after masking rv, which
    # only matters when the left candidate wins anyway.
    inside_r = lanes <= rend[:, None]
    mr = torch.where(inside_r, x_blocks[br], big)
    rv = torch.where(br > bl, signed_min(mr), big)
    ri = torch.where(inside_r & (mr == rv[:, None]), lanes, bs).min(dim=1).values
    rg = br * bs + ri

    take_l = lv <= rv  # left candidate has smaller indices: leftmost ties
    return torch.where(take_l, lv, rv), torch.where(take_l, lg, rg)


def rmq_partials(x_blocks, bl, br, lstart, lend, rend, *, tile: int = DEFAULT_TILE):
    """Fused partial-block candidates. Returns (value (B,), global idx (B,) int32).

    One kernel launch per batch on the card, ``tile`` queries (warps) per
    thread block; the bounds are cast to int32 on ``x_blocks``'s device.
    """
    if x_blocks.ndim != 2 or x_blocks.dtype not in _ENTRY:
        raise TypeError(
            f"rmq_partials takes (nb, bs) float32 or int32 blocks, got "
            f"{x_blocks.dtype} {tuple(x_blocks.shape)}"
        )
    dev = x_blocks.device
    args = [as_index(a, dev) for a in (bl, br, lstart, lend, rend)]
    if any(a.ndim != 1 or a.shape != args[0].shape for a in args):
        raise ValueError("rmq_partials: bl, br, lstart, lend, rend must be equal-shape 1-D")
    if dev.type == "cpu":
        return rmq_partials_plain(x_blocks, *args)
    if dev.type != "cuda":
        raise ValueError(f"rmq_partials runs on cuda or cpu tensors, got {dev}")
    if not x_blocks.is_contiguous():
        raise ValueError("rmq_partials needs a contiguous x_blocks")
    _build.check_pieces(x_blocks, "x_blocks", "rmq_partials")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}] warps per thread block, got {tile}")
    nb, bs = x_blocks.shape
    args = [a.contiguous() for a in args]
    b = args[0].shape[0]
    val = torch.empty(b, dtype=x_blocks.dtype, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return val, idx
    _build.launch(
        _ENTRY[x_blocks.dtype], "rmq_partials", dev,
        x_blocks.data_ptr(), *(a.data_ptr() for a in args), val.data_ptr(), idx.data_ptr(),
        b, nb, bs, tile,
    )
    with _count_lock:
        rmq_partials.launches += 1
    return val, idx


rmq_partials.launches = 0  # kernel launches since the last reset (plain calls do not count)
