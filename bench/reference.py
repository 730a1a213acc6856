"""The plain reference: exact leftmost range minima in plain PyTorch, and its
lower-precision control.

It imports nothing of the program and takes nothing the program built: it
works its answers out from the array and the bounds that the benchmark made.
Each element becomes one int64 key, its value's order in the high 32 bits
and its index in the low 32, so that the smallest key of a range is its
leftmost minimum. A doubling table of keys (``levels[k, i]`` the least key of
``[i, i + 2^k)``) answers a range with the lesser of two cells. The
tests hold it to a scan of every range on small arrays with ties.

``lower`` gives the control: the same reference over the array in the next
precision below the configuration's (bfloat16 for float32, a saturating
int4 for int32), which has to come out as not correct.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["ControlEngine", "Table", "build", "compare", "floor_log2", "lower", "order_keys", "query"]

_LOW32 = (1 << 32) - 1


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (value, index): float32 or int32 values."""
    idx = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    if x.dtype == torch.float32:
        bits = (x + 0.0).view(torch.int32)  # + 0.0 turns -0.0 into +0.0
        # Negative floats order backwards as integers: flip their low 31 bits.
        v = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    elif x.dtype == torch.int32:
        v = x
    else:
        raise TypeError(f"the reference takes float32 or int32 values, got {x.dtype}")
    return (v.to(torch.int64) << 32) | idx


class Table(NamedTuple):
    levels: torch.Tensor  # (K, n) int64 keys; row k holds minima of 2^k cells
    x: torch.Tensor  # (n,) the values the answers are read from


def build(x: torch.Tensor) -> Table:
    """The doubling table of ``x``'s keys, every level a range can need."""
    n = x.shape[0]
    k_levels = max(1, n.bit_length())  # 2^(K-1) <= n
    levels = torch.empty((k_levels, n), dtype=torch.int64, device=x.device)
    levels[0] = order_keys(x)
    for k in range(1, k_levels):
        h = 1 << (k - 1)
        m = n - 2 * h + 1  # windows of 2^k cells that fit
        torch.minimum(levels[k - 1, :m], levels[k - 1, h : h + m], out=levels[k, :m])
        levels[k, m:] = levels[k - 1, m:]  # never read: no range of 2^k starts there
    return Table(levels, x)


def floor_log2(length: torch.Tensor) -> torch.Tensor:
    """floor(log2(length)) for int64 lengths in [1, 2^31], by comparisons."""
    k = torch.zeros_like(length)
    for j in range(1, 32):
        k += length >= (1 << j)
    return k


def query(table: Table, l: torch.Tensor, r: torch.Tensor):
    """Leftmost argmin (int32) and its value of every ``[l, r]``."""
    n = table.levels.shape[1]
    flat = table.levels.view(-1)
    l = l.to(torch.int64)
    r = r.to(torch.int64)
    if l.numel() and (int(l.min()) < 0 or int(r.max()) >= n or bool((l > r).any())):
        raise ValueError("query bounds outside [0, n) or with l > r")
    k = floor_log2(r - l + 1)
    key = torch.minimum(flat[k * n + l], flat[k * n + r - (1 << k) + 1])
    idx = (key & _LOW32).to(torch.int32)
    return idx, table.x[idx]


def lower(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the next precision below its own, as the control computes:
    float32 rounded to bfloat16, int32 saturated to int4's [-8, 7]."""
    if x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    if x.dtype == torch.int32:
        return torch.clamp(x, -8, 7)
    raise TypeError(f"no lower precision for {x.dtype}")


class ControlEngine:
    """The reference in lower precision, put in the program's place."""

    def build(self, x, device=None):
        return build(lower(torch.as_tensor(x, device=device)))

    def query(self, state: Table, l, r):
        return query(state, l, r)


def compare(idx, val, ref_idx: torch.Tensor, ref_val: torch.Tensor):
    """``(wrong indices, wrong values, answers wrong in either)`` of one
    batch: values compared bit for bit; an answer of the wrong shape or type
    is wrong throughout."""
    b = ref_idx.shape[0]
    ok_idx = isinstance(idx, torch.Tensor) and idx.dtype == torch.int32 and idx.shape == ref_idx.shape
    ok_val = isinstance(val, torch.Tensor) and val.dtype == ref_val.dtype and val.shape == ref_val.shape
    if not (ok_idx and ok_val):
        return b, b, b
    idx = idx.to(ref_idx.device)
    val = val.to(ref_val.device)
    if ref_val.dtype == torch.float32:
        val, ref_val = val.view(torch.int32), ref_val.view(torch.int32)
    bad_idx = idx != ref_idx
    bad_val = val != ref_val
    return int(bad_idx.sum()), int(bad_val.sum()), int((bad_idx | bad_val).sum())
