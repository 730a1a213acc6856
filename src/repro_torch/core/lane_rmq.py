"""The O(1) gather RMQ over 128-wide lane blocks ("lane RMQ").

Per lane block, prefix and suffix minima are precomputed, so a query
decomposes into gathers:

    answer(l, r) = min( suffix_min[l]      # tail of l's lane block
                      , ST(block minima)   # fully covered lane blocks, O(1)
                      , prefix_min[r] )    # head of r's lane block

Only a query inside a single lane block touches raw data: one 128-wide
masked min. Port of ``repro/core/lane_rmq.py``. The build's min-pair scans
are torch ops; every index is the leftmost argmin and every value the one
that index holds (a -0.0 as +0.0), as the reference's associative scan
gives them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch._device import as_index, resolve

from . import sparse_table
from .block_rmq import _pick, leftmost_min, maxval, pad_blocks

LANE = 128

__all__ = ["LaneRMQ", "build", "query", "LANE"]


class LaneRMQ(NamedTuple):
    xs: torch.Tensor  # (nsub, LANE) padded values
    pref_val: torch.Tensor  # (nsub, LANE) prefix minima within a lane block
    pref_idx: torch.Tensor  # (nsub, LANE) int32 global leftmost argmin
    suff_val: torch.Tensor  # (nsub, LANE) suffix minima within a lane block
    suff_idx: torch.Tensor  # (nsub, LANE) int32
    st: sparse_table.SparseTable  # over per-lane-block minima
    sub_gidx: torch.Tensor  # (nsub,) int32 global argmin per lane block


def _prefix_lanes(xs: torch.Tensor) -> torch.Tensor:
    """Leftmost argmin lane of every prefix ``xs[:, :j+1]``: the last lane
    at or before ``j`` whose value is strictly below every earlier one."""
    run = torch.cummin(xs, dim=1).values  # values only: its tie rule is unused
    lanes = torch.arange(xs.shape[1], dtype=torch.int64, device=xs.device).expand_as(xs)
    new_min = torch.ones_like(xs, dtype=torch.bool)
    new_min[:, 1:] = xs[:, 1:] < run[:, :-1]
    return torch.cummax(torch.where(new_min, lanes, 0), dim=1).values


def _suffix_lanes(xs: torch.Tensor) -> torch.Tensor:
    """Leftmost argmin lane of every suffix ``xs[:, j:]``: the first lane at
    or after ``j`` whose value is at most the minimum of the lanes after it."""
    w = xs.shape[1]
    run = torch.cummin(xs.flip(1), dim=1).values.flip(1)  # suffix minima
    lanes = torch.arange(w, dtype=torch.int64, device=xs.device).expand_as(xs)
    stop = torch.ones_like(xs, dtype=torch.bool)
    stop[:, :-1] = xs[:, :-1] <= run[:, 1:]
    first = torch.where(stop, lanes, w).flip(1)
    return torch.cummin(first, dim=1).values.flip(1)


def build(x, *, device=None) -> LaneRMQ:
    """Pad ``x`` to whole lane blocks and precompute the min-pair scans."""
    x = torch.as_tensor(x, device=resolve(device))
    xs = pad_blocks(x, LANE)
    base = (torch.arange(xs.shape[0], dtype=torch.int32, device=xs.device) * LANE)[:, None]
    pl = _prefix_lanes(xs)
    sl = _suffix_lanes(xs)
    # "+ 0": the reference's associative scan interleaves its halves by adding
    # zero-padded planes, so every -0.0 it outputs is +0.0; the planes match.
    suff_val = xs.gather(1, sl) + 0
    return LaneRMQ(
        xs=xs,
        pref_val=xs.gather(1, pl) + 0,
        pref_idx=base + pl.to(torch.int32),
        suff_val=suff_val,
        suff_idx=base + sl.to(torch.int32),
        st=sparse_table.build(suff_val[:, 0].contiguous()),  # suffix at lane 0 == block min
        sub_gidx=base[:, 0] + sl[:, 0].to(torch.int32),
    )


def query(s: LaneRMQ, l, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched O(1)-gather RMQ. Returns (leftmost argmin index int32, value)."""
    nsub = s.xs.shape[0]
    big = maxval(s.xs.dtype)
    dev = s.xs.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    sl = l // LANE
    sr = r // LANE
    llo = l - sl * LANE
    rlo = r - sr * LANE
    same = sl == sr

    # Straddling path: three gathers and the interior table.
    lv = s.suff_val[sl, llo]
    li = s.suff_idx[sl, llo]
    rv = s.pref_val[sr, rlo]
    ri = s.pref_idx[sr, rlo]
    has_interior = (sr - sl) >= 2
    ilo = torch.clamp(sl + 1, 0, nsub - 1)
    ihi = torch.maximum(torch.clamp(sr - 1, 0, nsub - 1), ilo)
    bi = sparse_table.query(s.st, ilo, ihi)
    iv = torch.where(has_interior, s.st.x[bi], big)
    ii = s.sub_gidx[bi]
    v, i = _pick(lv, li, iv, ii)
    v, i = _pick(v, i, torch.where(same, big, rv), ri)

    # Same-lane-block path: one 128-wide masked min.
    lanes = torch.arange(LANE, dtype=torch.int32, device=dev)[None, :]
    inside = (lanes >= llo[:, None]) & (lanes <= rlo[:, None])
    sv, lidx = leftmost_min(s.xs[sl], inside)
    si = sl * LANE + lidx
    return torch.where(same, si, i), torch.where(same, sv, v)
