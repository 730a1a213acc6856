"""RMQ-powered sequence packing — the paper's technique used inside the
LM framework.

Port of ``repro/data/packing.py``. Greedy worst-fit-decreasing packing of
documents into fixed-length training sequences: for each document, find
the open bin with the most remaining space — a range-MAX query, i.e. RMQ
over negated free space — on the blocked RMQ engine (``core.block_rmq``)
on ``device``. The free-space array lives on the host and updates in
place; the structure is rebuilt every ``rebuild_every`` placements, so a
lookup may be stale: its hint is checked on the live array, with an exact
scan as the fallback. When no bin fits, the bins double.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import block_rmq

__all__ = ["pack_documents"]


def pack_documents(
    lengths: np.ndarray,
    seq_len: int,
    *,
    num_bins: int | None = None,
    block_size: int = 128,
    rebuild_every: int = 128,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack documents (lengths) into bins of capacity seq_len.

    Returns (bin assignment per doc, free space per bin), numpy int64.
    Documents longer than seq_len are truncated to seq_len.
    """
    dev = resolve(device)
    lengths = np.minimum(np.asarray(lengths, np.int64), seq_len)
    order = np.argsort(-lengths)  # largest first
    n = len(lengths)
    if num_bins is None:
        num_bins = max(1, int(np.ceil(lengths.sum() / seq_len * 1.3)))
    free = np.full(num_bins, seq_len, np.int64)
    assign = np.full(n, -1, np.int64)

    def build():  # RMQ over negated free space: argmin(-free) == argmax(free)
        return block_rmq.build(torch.from_numpy((-free).astype(np.int32)), block_size, device=dev)

    structure = build()
    dirty = 0
    for d in order:
        need = lengths[d]
        idx, _ = block_rmq.query(structure, [0], [num_bins - 1])
        b = int(idx[0])
        # the structure may be stale: check the hint on the live array
        if free[b] < need:
            b = int(np.argmax(free))
        if free[b] < need:  # all bins full: open fresh bins
            free = np.concatenate([free, np.full(num_bins, seq_len, np.int64)])
            num_bins *= 2
            b = int(np.argmax(free))
            structure = build()
            dirty = 0
        assign[d] = b
        free[b] -= need
        dirty += 1
        if dirty >= rebuild_every:
            structure = build()
            dirty = 0

    return assign, free
