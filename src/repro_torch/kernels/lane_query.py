"""Lane-RMQ candidates other than the interior: wrapper and plain version.

``lane_partials`` launches the CUDA kernel of ``csrc/lane_partials.cu`` for
CUDA tensors and runs ``lane_partials_plain`` for CPU tensors. The kernel
replaces the Pallas TPU kernel ``lane_partials`` (src/repro/kernels/
lane_query.py): for a query inside one lane block, the masked min of its
raw row; for a straddling one, the suffix minimum at ``(sl, llo)`` against
the prefix minimum at ``(sr, rlo)``, suffix first on ties. It is the first
pass of ``ops.lane_query``, whose interior and merge stay in PyTorch. The
source note of the kernel gives its bound and design.
"""

from __future__ import annotations

import threading

import torch

from repro_torch._device import as_index
from repro_torch.core.block_rmq import kernel_leftmost_min
from repro_torch.core.lane_rmq import LANE

from . import _build
from .tuning import DEFAULT_TILE, MAX_TILE

__all__ = ["lane_partials", "lane_partials_plain", "DEFAULT_TILE"]

_ENTRY = {torch.float32: "repro_lane_partials_f32", torch.int32: "repro_lane_partials_i32"}
_count_lock = threading.Lock()


def lane_partials_plain(xs, suff_val, suff_idx, pref_val, pref_idx, sl, sr, llo, rlo):
    """The reference kernel's arithmetic (lane_query.py:52-71): the straddle
    pick (``lv <= rv`` keeps the suffix) and the masked-iota min of the raw
    row, selected by ``sl == sr``; a lane outside the row's range never wins
    a tie (the repair of ROADMAP.md §3). Returns (value, global idx)."""
    lv = suff_val[sl, llo]
    li = suff_idx[sl, llo]
    rv = pref_val[sr, rlo]
    ri = pref_idx[sr, rlo]
    take_l = lv <= rv  # suffix candidate has smaller indices on ties
    str_v = torch.where(take_l, lv, rv)
    str_i = torch.where(take_l, li, ri)

    lanes = torch.arange(LANE, dtype=torch.int32, device=xs.device)[None, :]
    mv, mi = kernel_leftmost_min(xs[sl], (lanes >= llo[:, None]) & (lanes <= rlo[:, None]))
    mi = sl * LANE + mi

    same = sl == sr
    return torch.where(same, mv, str_v), torch.where(same, mi, str_i)


def lane_partials(
    xs, suff_val, suff_idx, pref_val, pref_idx, sl, sr, llo, rlo, *, tile: int = DEFAULT_TILE
):
    """Fused non-interior lane candidates. Returns (value (B,), global idx (B,) int32).

    ``xs`` and the four scan planes are ``(nsub, 128)``; one kernel launch
    per batch on the card. A warp of the kernel owns 4 queries, one per lane
    0..3, so ``tile`` is the warps per thread block, 4 queries each.
    """
    if xs.ndim != 2 or xs.shape[1] != LANE or xs.dtype not in _ENTRY:
        raise TypeError(
            f"lane_partials takes (nsub, {LANE}) float32 or int32 rows, got "
            f"{xs.dtype} {tuple(xs.shape)}"
        )
    dev = xs.device
    args = [as_index(a, dev) for a in (sl, sr, llo, rlo)]
    if any(a.ndim != 1 or a.shape != args[0].shape for a in args):
        raise ValueError("lane_partials: sl, sr, llo, rlo must be equal-shape 1-D")
    planes = (suff_val, suff_idx, pref_val, pref_idx)
    if dev.type == "cpu":
        return lane_partials_plain(xs, *planes, *args)
    if dev.type != "cuda":
        raise ValueError(f"lane_partials runs on cuda or cpu tensors, got {dev}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}] warps per thread block, got {tile}")
    for name, t, dtype in zip(
        ("xs", "suff_val", "suff_idx", "pref_val", "pref_idx"),
        (xs, *planes),
        (xs.dtype, xs.dtype, torch.int32, xs.dtype, torch.int32),
    ):
        if t.dtype != dtype or t.device != dev or t.shape != xs.shape or not t.is_contiguous():
            raise ValueError(
                f"lane_partials: {name} must be a contiguous {dtype} {tuple(xs.shape)} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    _build.check_pieces(xs, "xs", "lane_partials")
    args = [a.contiguous() for a in args]
    b = args[0].shape[0]
    val = torch.empty(b, dtype=xs.dtype, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return val, idx
    _build.launch(
        _ENTRY[xs.dtype], "lane_partials", dev,
        xs.data_ptr(), *(t.data_ptr() for t in planes), *(a.data_ptr() for a in args),
        val.data_ptr(), idx.data_ptr(), b, xs.shape[0], tile,
    )
    with _count_lock:
        lane_partials.launches += 1
    return val, idx


lane_partials.launches = 0  # kernel launches since the last reset (plain calls do not count)
