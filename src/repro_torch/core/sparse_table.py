"""Sparse-table (doubling) RMQ: O(n log n) build, O(1) batched query.

The level-2 structure of the blocked RMQ, and on its own the long-range path
of the hybrid engine. The table stores *indices* (int32), so a query answers
argmin directly and the leftmost-tie convention holds exactly (``_pick_left``).
Port of ``repro/core/sparse_table.py`` (unpacked half).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import as_index

__all__ = ["SparseTable", "build", "exact_log2", "query"]


class SparseTable(NamedTuple):
    """Doubling table over ``x``. ``idx[k, i]`` = leftmost argmin of x[i : i+2^k]."""

    idx: torch.Tensor  # (K, n) int32
    x: torch.Tensor  # (n,) values the table indexes into


def _pick_left(x, a, b):
    """Leftmost-tie argmin merge: prefer ``a`` when values tie.

    Correct whenever, on ties, position ``a`` is <= the leftmost min (holds
    for both the build windows and the query overlap).
    """
    return torch.where(x[a] <= x[b], a, b)


def build(x: torch.Tensor) -> SparseTable:
    """Build the doubling table on ``x``'s device (K <= 32 levels).

    Levels whose half-width ``h`` reaches past the end of the array repeat
    the previous level; a level with ``h < n`` shifts by ``h`` and clamps the
    tail to the last cell (``cur[-1]``), exactly as the reference does. The
    table is written level by level into one preallocated ``(K, n)`` tensor.
    """
    n = x.shape[0]
    k_levels = max(1, (n - 1).bit_length() + 1) if n > 1 else 1
    idx = torch.empty((k_levels, n), dtype=torch.int32, device=x.device)
    cur = torch.arange(n, dtype=torch.int32, device=x.device)
    idx[0] = cur
    for k in range(1, k_levels):
        h = 1 << (k - 1)
        if h < n:
            shifted = torch.cat([cur[h:], cur[-1:].expand(h)])
            cur = _pick_left(x, cur, shifted)
        idx[k] = cur
    return SparseTable(idx=idx, x=x)


def exact_log2(length: torch.Tensor) -> torch.Tensor:
    """floor(log2(length)) as int32, exact for every int32 length >= 1.

    A float32 log2 can be off by one next to powers of two; two integer
    corrections restore 2^k <= length < 2^(k+1). The corrections shift in
    int64: in int32, ``1 << 31`` wraps negative and the reference returns 31
    for length 2^31 - 1 (ROADMAP.md, faults found against the reference).
    """
    k = torch.floor(torch.log2(length.to(torch.float32))).to(torch.int64)
    k = torch.clamp(k, min=0)
    wide = length.to(torch.int64)
    one = torch.ones_like(wide)
    k = torch.where((one << k) > wide, k - 1, k)
    k = torch.where((one << (k + 1)) <= wide, k + 1, k)
    return k.to(torch.int32)


def query(table: SparseTable, l, r) -> torch.Tensor:
    """Batched O(1) query. Returns leftmost argmin indices (int32)."""
    dev = table.idx.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    k = exact_log2(r - l + 1)
    a = table.idx[k, l]
    b = table.idx[k, r - (1 << k) + 1]
    return _pick_left(table.x, a, b)
