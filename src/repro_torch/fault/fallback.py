"""Degraded fallback engine: a plain sparse table per pinned version.

When the serve circuit breaker opens (the primary engine keeps failing),
queries route here instead of erroring: correct answers, slower path. The
fallback builds a plain ``sparse_table`` (no CUDA kernel, no state shared
with the primary) from the pinned version's logical host array
(``update.Version.x_host``), so even mid-mutation traffic is answered
against exactly its snapshot. An LRU of a few versions bounds the rebuild
cost under version churn. Port of ``repro/fault/fallback.py`` for online
servers (a static server's breaker takes its own ``fallback=`` callable);
the tables live on ``device`` (``None``: CUDA).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
import torch

from repro_torch._device import as_index, resolve
from repro_torch.core import sparse_table
from repro_torch.core.sparse_table import SparseTable

__all__ = ["DegradedFallback"]

CACHED_VERSIONS = 4  # sparse tables kept, least recently used dropped first


def _query(table: SparseTable, l, r):
    idx = sparse_table.query(table, l, r)
    return idx, table.x[idx]


class DegradedFallback:
    """Correct-but-slower query engine for breaker-open serving.

    ``query(ver, l, r)`` answers against version ``ver`` (an
    ``update.Version`` with ``x_host``).
    """

    def __init__(self, *, device=None):
        self._device = resolve(device)
        self._cache: "OrderedDict[int, SparseTable]" = OrderedDict()
        self._lock = threading.Lock()

    def _table_for(self, ver) -> SparseTable:
        with self._lock:
            table = self._cache.get(ver.vid)
            if table is not None:
                self._cache.move_to_end(ver.vid)
                return table
        if ver.x_host is None:
            raise RuntimeError(
                f"version {ver.vid} carries no host array; the degraded "
                f"fallback needs Version.x_host to build from"
            )
        table = sparse_table.build(torch.as_tensor(ver.x_host).to(self._device))
        with self._lock:
            self._cache[ver.vid] = table
            while len(self._cache) > CACHED_VERSIONS:
                self._cache.popitem(last=False)
        return table

    def query(self, ver, l, r):
        table = self._table_for(ver)
        return _query(table, as_index(l, self._device), as_index(r, self._device))
