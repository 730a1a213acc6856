"""Sparse-table (doubling) RMQ: O(n log n) build, O(1) batched query.

The level-2 structure of the blocked RMQ, and on its own the long-range path
of the hybrid engine. The table stores *indices* (int32), so a query answers
argmin directly and the leftmost-tie convention holds exactly (``_pick_left``).
Port of ``repro/core/sparse_table.py``. The packed half keeps one word
plane instead of ``idx`` + ``x`` (``core.packing``): a query reads two cells
and is done; quantized bucket ties fall back to an exact value compare.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._device import as_index

from . import packing

__all__ = [
    "PackedSparseTable",
    "SparseTable",
    "build",
    "build_packed",
    "exact_log2",
    "query",
    "query_packed",
]


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


def _levels(n: int) -> int:
    return max(1, (n - 1).bit_length() + 1) if n > 1 else 1


def build(x: torch.Tensor) -> SparseTable:
    """Build the doubling table on ``x``'s device (K <= 32 levels).

    Levels whose half-width ``h`` reaches past the end of the array repeat
    the previous level; a level with ``h < n`` shifts by ``h`` and clamps the
    tail to the last cell (``cur[-1]``), exactly as the reference does. The
    table is written level by level into one preallocated ``(K, n)`` tensor.
    """
    n = x.shape[0]
    k_levels = _levels(n)
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


# --- packed variant ---------------------------------------------------------


class PackedSparseTable(NamedTuple):
    """Doubling table of packed words.

    ``words[k, i]`` encodes the leftmost argmin of ``x[i : i+2^k]`` as one
    ``(key << idx_bits) | index`` word. ``x`` is kept only for the quantized
    layout's exact bucket-tie fallback (None for packed64/packed32).
    """

    words: torch.Tensor  # (K, n) packed words
    x: Optional[torch.Tensor] = None  # (n,) raw values, quantized only


def doubling_min(words: torch.Tensor) -> torch.Tensor:
    """``(K, n)`` doubling table over packed words: a plain ``minimum`` per
    level (the word order is the leftmost-argmin order), with the tail clamp
    and repeated levels of :func:`build`."""
    n = words.shape[0]
    out = torch.empty((_levels(n), n), dtype=words.dtype, device=words.device)
    cur = words
    out[0] = cur
    for k in range(1, out.shape[0]):
        h = 1 << (k - 1)
        if h < n:
            cur = torch.minimum(cur, torch.cat([cur[h:], cur[-1:].expand(h)]))
        out[k] = cur
    return out


def build_packed(x: torch.Tensor, spec=None, layout: str = "auto"):
    """Build the packed doubling table; returns ``(PackedSparseTable, spec)``.

    Exact layouts fold the doubling merge into ``minimum`` over words. The
    quantized layout builds the exact index table first and encodes each
    cell's exact argmin with its bucket, one level at a time (the bucket
    temporaries of a whole (K, n) table would be several times its size).
    """
    n = x.shape[0]
    if spec is None:
        spec = packing.spec_for(x, n, layout)
    if spec.layout == "quantized":
        t = build(x)
        words = torch.empty_like(t.idx)
        for k in range(t.idx.shape[0]):
            words[k] = packing.pack(spec, x[t.idx[k]], t.idx[k])
        return PackedSparseTable(words=words, x=x), spec
    cur = packing.pack(spec, x, torch.arange(n, dtype=torch.int32, device=x.device))
    return PackedSparseTable(words=doubling_min(cur)), spec


def query_packed(table: PackedSparseTable, spec, l, r):
    """Batched O(1) packed query -> ``(idx int32, val)``, exact leftmost ties."""
    dev = table.words.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    k = exact_log2(r - l + 1)
    wa = table.words[k, l]
    wb = table.words[k, r - (1 << k) + 1]
    if spec.layout != "quantized":
        w = torch.minimum(wa, wb)
        return packing.unpack_idx(spec, w), packing.unpack_val(spec, w)
    # Bucket-tie fallback: equal buckets compare both exact values; window
    # containment gives ia <= ib on exact value ties (the _pick_left rule).
    ia = packing.unpack_idx(spec, wa)
    ib = packing.unpack_idx(spec, wb)
    va = table.x[ia]
    vb = table.x[ib]
    collide = (wa >> spec.idx_bits) == (wb >> spec.idx_bits)
    take_a = torch.where(collide, va <= vb, wa <= wb)
    return torch.where(take_a, ia, ib), torch.where(take_a, va, vb)
