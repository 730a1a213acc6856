"""LCA baseline (paper §6.1 "LCA", Polak et al. style).

RMQ -> LCA reduction over the Cartesian tree: build the tree (nearest-smaller
stack, O(n), host-side numpy as a preprocessing stage, like the GPU baseline's
Euler-tour construction), take an Euler tour, and answer RMQ(l, r) as the
min-depth node between the first occurrences of l and r — a ±1-RMQ served
with the doubling table on the structure's device. Port of
``repro/core/lca.py``: the tree and the tour are the reference's numpy code,
unchanged; the table and the batched queries are torch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import as_index, to_numpy

from . import sparse_table

__all__ = ["LCARMQ", "build", "query"]


class LCARMQ(NamedTuple):
    euler_node: torch.Tensor  # (2n-1,) int32 node (=array index) per tour step
    first: torch.Tensor  # (n,) int32 first occurrence of each node in the tour
    st: sparse_table.SparseTable  # over tour depths


def _cartesian_tree(x: np.ndarray):
    """left/right children + root; strict '>' pops keep leftmost ties on top."""
    n = x.shape[0]
    left = np.full(n, -1, dtype=np.int64)
    right = np.full(n, -1, dtype=np.int64)
    stack: list[int] = []
    for i in range(n):
        last = -1
        while stack and x[stack[-1]] > x[i]:
            last = stack.pop()
        left[i] = last
        if stack:
            right[stack[-1]] = i
        stack.append(i)
    return left, right, stack[0]


def build(x, *, device=None) -> LCARMQ:
    """Tree and tour on the host; the tables on ``device`` (default: x's)."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    x = to_numpy(x)
    n = x.shape[0]
    left, right, root = _cartesian_tree(x)

    tour_node = np.empty(2 * n - 1, dtype=np.int32)
    tour_depth = np.empty(2 * n - 1, dtype=np.int32)
    first = np.full(n, -1, dtype=np.int32)
    # Iterative Euler tour: re-record the parent after each child subtree.
    stack = [(int(root), 0, False)]
    pos = 0
    while stack:
        node, d, revisit = stack.pop()
        tour_node[pos] = node
        tour_depth[pos] = d
        if first[node] < 0:
            first[node] = pos
        pos += 1
        if not revisit:
            children = [c for c in (left[node], right[node]) if c >= 0]
            seq = []
            for c in children:
                seq.append(("v", int(c), d + 1))
                seq.append(("r", node, d))
            for op, nd, dd in reversed(seq):
                stack.append((nd, dd, op == "r"))
        # revisit entries carry no children (their subtrees were queued already)
    assert pos == 2 * n - 1, (pos, n)

    dev = torch.device("cpu") if device is None else torch.device(device)
    st = sparse_table.build(torch.from_numpy(tour_depth).to(dev))
    return LCARMQ(
        euler_node=torch.from_numpy(tour_node).to(dev),
        first=torch.from_numpy(first).to(dev),
        st=st,
    )


def query(s: LCARMQ, l, r) -> torch.Tensor:
    """Batched query. Returns leftmost argmin indices (int32)."""
    dev = s.first.device
    fl = s.first[as_index(l, dev)]
    fr = s.first[as_index(r, dev)]
    lo = torch.minimum(fl, fr)
    hi = torch.maximum(fl, fr)
    pos = sparse_table.query(s.st, lo, hi)
    return s.euler_node[pos]
