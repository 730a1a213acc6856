"""EXHAUSTIVE baseline (paper §6.1): a masked scan of X per query.

The paper's EXHAUSTIVE is one CUDA thread scanning [l, r]; as in the
reference, it is a batched masked argmin over the whole array, O(n) per
query, used as the brute-force baseline and as a second oracle in tests.
Port of ``repro/core/exhaustive.py``.

A chunk of queries materialises a ``(chunk, n)`` mask and masked copy of x.
XLA may fuse those away; eager PyTorch does not, so the chunk is also
bounded by bytes (``_CHUNK_BYTES``): at n = 2^26 float32 a chunk of 256
queries would be 64 GiB. The answers do not depend on the chunking.

Masked lanes carry the dtype's maximum, as in the reference. Where the
range's minimum is that maximum, the argmin would land on a masked lane
left of the range (the reference's answer); the port answers with the
range's first index instead (ROADMAP.md §3).
"""

from __future__ import annotations

import torch

from repro_torch._device import as_index

__all__ = ["rmq_exhaustive"]

# Bytes of one chunk's masked (chunk, n) copy of x.
_CHUNK_BYTES = 1 << 28


def _maxval(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def rmq_exhaustive(x: torch.Tensor, l, r, *, query_chunk: int = 256) -> torch.Tensor:
    """Batched brute-force RMQ. Returns leftmost argmin indices (int32).

    Chunked over queries: at most ``query_chunk`` queries, and at most
    ``_CHUNK_BYTES`` of masked copy, per chunk. ``torch.argmin`` returns the
    first minimal index on both the CPU and CUDA (pinned by the tests and by
    ``chip_smoke.py``).
    """
    n = x.shape[0]
    dev = x.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    chunk = max(1, min(query_chunk, _CHUNK_BYTES // max(1, n * x.element_size())))
    big = torch.tensor(_maxval(x.dtype), dtype=x.dtype, device=dev)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    out = torch.empty(l.shape[0], dtype=torch.int32, device=dev)
    for s in range(0, l.shape[0], chunk):
        lc = l[s : s + chunk, None]
        rc = r[s : s + chunk, None]
        inside = (idx[None, :] >= lc) & (idx[None, :] <= rc)
        masked = torch.where(inside, x[None, :], big)
        a = torch.argmin(masked, dim=1)
        only_max = masked.gather(1, a[:, None])[:, 0] == big
        out[s : s + chunk] = torch.where(only_max, lc[:, 0], a.to(torch.int32))
    return out
