"""Pure micro-batching core: coalesce, power-of-two pad, scatter back.

Concurrent client requests are concatenated *in arrival order* into one
engine batch, the batch is padded to the next power of two, and after the
engine answers, each request gets back exactly its slice. Order-preserving
concatenation is what makes the scatter-back trivially exact: the engines
already implement exact leftmost-tie semantics per query, and no
re-ordering ever happens across the coalesce/scatter round-trip.

Padding every launch to a power-of-two bucket bounds the engine's jit
cache: however client batch sizes vary, a server with ``max_batch`` queries
per launch compiles at most ``log2(bucket(max_batch)) + 1`` shapes per
engine path. Pad queries are the trivial ``(0, 0)`` range (cheap, always
valid) and are sliced off before the scatter-back.

This module is deliberately free of threads and clocks so the exact
coalescing/padding/scatter logic unit-tests against the numpy oracle;
``server.RMQServer`` supplies the queue, deadline loop, and worker pool.
A copy of ``repro/serve/batcher.py``; only ``scatter_back``'s host copy
differs.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from repro_torch._device import to_numpy

__all__ = ["MicroBatch", "bucket", "coalesce", "scatter_back"]


def bucket(b: int) -> int:
    """Smallest power of two >= b: the padded launch shape for a b-query batch."""
    if b < 1:
        raise ValueError(f"batch size must be >= 1, got {b}")
    return 1 << (b - 1).bit_length()


class MicroBatch(NamedTuple):
    """One coalesced engine launch assembled from whole client requests."""

    l: np.ndarray  # (bucket(n_queries),) int32; tail padded with 0
    r: np.ndarray  # (bucket(n_queries),) int32; tail padded with 0
    n_queries: int  # valid prefix length (pre-padding)
    spans: Tuple[Tuple[int, int], ...]  # per-request (offset, length), arrival order

    @property
    def padded_size(self) -> int:
        """The launch shape actually compiled/executed (== bucket(n_queries))."""
        return self.l.shape[0]

    @property
    def fill_fraction(self) -> float:
        """Real queries / padded slots — the coalescing-efficiency signal the
        flush span exports (1.0 = the pad cost nothing)."""
        return self.n_queries / self.padded_size if self.padded_size else 0.0


def coalesce(ls: Sequence[np.ndarray], rs: Sequence[np.ndarray]) -> MicroBatch:
    """Concatenate per-request (l, r) in arrival order and pad to the bucket.

    Raises ``ValueError`` on a malformed request set: `ls`/`rs` of different
    lengths, or any request whose l and r arrays are not equal-length 1-D.
    Sizing the batch from `ls` alone while iterating ``zip(ls, rs)`` used to
    turn such mismatches into zero-filled slots silently answered as (0, 0)
    RMQs — wrong answers, not an error.
    """
    if len(ls) != len(rs):
        raise ValueError(
            f"coalesce: {len(ls)} l-arrays vs {len(rs)} r-arrays (must match)"
        )
    ls = [np.asarray(a) for a in ls]
    rs = [np.asarray(a) for a in rs]
    for i, (la, ra) in enumerate(zip(ls, rs)):
        if la.ndim != 1 or ra.ndim != 1 or la.shape != ra.shape:
            raise ValueError(
                f"coalesce: request {i} l/r must be equal-length 1-D arrays, "
                f"got shapes {la.shape} and {ra.shape}"
            )
    sizes = [a.shape[0] for a in ls]
    b = int(sum(sizes))
    bp = bucket(b)
    l = np.zeros(bp, np.int32)
    r = np.zeros(bp, np.int32)
    spans: List[Tuple[int, int]] = []
    off = 0
    for la, ra in zip(ls, rs):
        k = la.shape[0]
        l[off : off + k] = la
        r[off : off + k] = ra
        spans.append((off, k))
        off += k
    return MicroBatch(l=l, r=r, n_queries=b, spans=tuple(spans))


def scatter_back(mb: MicroBatch, idx, val) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Slice batch results back per request (arrival order, pads dropped).

    Engine results that are device tensors come to the host here, one copy
    each per launch. Copies so a request's result never pins the whole
    batch's buffers.
    """
    idx = to_numpy(idx)
    val = to_numpy(val)
    return [(idx[o : o + k].copy(), val[o : o + k].copy()) for o, k in mb.spans]
