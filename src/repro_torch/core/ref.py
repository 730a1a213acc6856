"""Reference RMQ oracles.

``rmq_ref`` is the ground-truth used by every test and kernel sweep: a plain
numpy scan per query, returning the *leftmost* argmin index, matching the
paper's tie-breaking convention (Section 2).
"""

from __future__ import annotations

import numpy as np

__all__ = ["rmq_ref", "rmq_values_ref"]


def rmq_ref(x, l, r) -> np.ndarray:
    """Batched ground-truth RMQ. Returns leftmost argmin index per query.

    Args:
      x: (n,) array of comparable values.
      l, r: (B,) integer arrays with 0 <= l <= r < n.
    """
    x = np.asarray(x)
    l = np.asarray(l).ravel()
    r = np.asarray(r).ravel()
    if np.any(l > r) or np.any(l < 0) or np.any(r >= x.shape[0]):
        raise ValueError("invalid query bounds")
    out = np.empty(l.shape, dtype=np.int64)
    for q in range(l.size):
        seg = x[l[q] : r[q] + 1]
        out[q] = l[q] + int(np.argmin(seg))  # np.argmin returns first (leftmost) min
    return out


def rmq_values_ref(x, l, r) -> np.ndarray:
    """Batched ground-truth range-minimum *values*."""
    x = np.asarray(x)
    return x[rmq_ref(x, l, r)]
