"""Range-adaptive hybrid RMQ dispatcher (the paper's crossover, exploited).

The blocked structure is fastest for *short* ranges; the O(1) sparse table
overtakes it at medium and large ranges. A batch is partitioned on the host
by range length against a threshold: short ranges go to the blocked path
(the fused CUDA kernel ``kernels.ops`` when ``use_kernels``, else the plain
``block_rmq``), long ranges to the sparse table over the raw array, and the
two result sets are scattered back into batch order. Results equal
``block_rmq.query`` bit for bit. Port of ``repro/core/hybrid.py``
(``calibrate`` is a later slice, see ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch._device import as_index, to_numpy
from repro_torch.obs import trace as obs_trace

from . import block_rmq, sparse_table

__all__ = [
    "HybridRMQ",
    "assemble",
    "build",
    "query",
    "dispatch_by_length",
    "record_splits",
    "DEFAULT_THRESHOLD_FRAC",
]

# Threshold when none is given: ranges shorter than sqrt(n) touch only a
# couple of blocks and favor the blocked path.
DEFAULT_THRESHOLD_FRAC = 0.5  # threshold = n ** DEFAULT_THRESHOLD_FRAC

_INT32_MAX = np.iinfo(np.int32).max


class HybridRMQ(NamedTuple):
    """Both constituent structures, routing threshold, path closures."""

    blocked: object  # BlockRMQ (plain path) | kernels.ops.FusedRMQ (kernel path)
    st: sparse_table.SparseTable  # doubling table over the raw array
    x: torch.Tensor  # raw values (answers value lookups for the long path)
    threshold: int  # range lengths <= threshold go to the blocked path
    use_kernels: bool  # short path: fused CUDA kernel vs plain block_rmq
    short_fn: object  # (l, r) -> (idx, val), structure closed over
    long_fn: object  # (l, r) -> (idx, val)


def build(
    x,
    block_size: int = 128,
    *,
    threshold: int | None = None,
    use_kernels: bool | None = None,
    kernel_config=None,
    device=None,
) -> HybridRMQ:
    """Build both constituent engines on ``device`` (via the ``core.build`` plan).

    ``threshold=None`` -> the sqrt(n) default; an int pins it.
    ``use_kernels=None`` -> the kernels exactly when the structure lives on a
    CUDA device. ``kernel_config`` is None (the default geometry) or a
    ``kernels.tuning.KernelConfig``.
    """
    from . import build as build_mod  # deferred: build.py hosts the planner

    return build_mod.build(
        "hybrid",
        x,
        block_size=block_size,
        threshold=threshold,
        use_kernels=use_kernels,
        kernel_config=kernel_config,
        device=device,
    )


def assemble(blocked, st, x, threshold: int, use_kernels: bool, kernel_config=None) -> HybridRMQ:
    """A ``HybridRMQ`` over built parts: the path closures bound to them."""
    if use_kernels:
        from repro_torch.kernels import ops

        short_fn = lambda l, r: ops.query(blocked, l, r, config=kernel_config)
    else:
        short_fn = lambda l, r: block_rmq.query(blocked, l, r)

    def long_fn(l, r):
        idx = sparse_table.query(st, l, r)
        return idx, x[idx]

    return HybridRMQ(
        blocked=blocked,
        st=st,
        x=x,
        threshold=int(threshold),
        use_kernels=bool(use_kernels),
        short_fn=short_fn,
        long_fn=long_fn,
    )


# Per-thread sink for regime-split observations: the serving layer wraps each
# engine launch in ``record_splits`` so its stats can report how dispatch
# partitioned every coalesced batch without coupling the engines to the server.
_split_sink = threading.local()


@contextlib.contextmanager
def record_splits(cb):
    """Route this thread's ``dispatch_by_length`` splits to ``cb(n_short, n_long)``."""
    prev = getattr(_split_sink, "cb", None)
    _split_sink.cb = cb
    try:
        yield
    finally:
        _split_sink.cb = prev


def dispatch_by_length(l, r, threshold: int, short_fn, long_fn, out_dtype, device):
    """Range-adaptive dispatch core: partition, per-regime launches, scatter-back.

    Host-side partition of the batch by range length against ``threshold``,
    per-regime launches through ``short_fn`` / ``long_fn`` (each
    ``(l, r) -> (idx, val)`` on int32 tensors on ``device``), ordered exact
    scatter-back. Empty batches return empty ``(idx, val)`` without
    launching anything.

    Bounds must be integer arrays inside the int32 index range: every
    constituent computes int32 indices, so an out-of-range bound would wrap
    silently instead of failing loudly.
    """
    l = to_numpy(l)
    r = to_numpy(r)
    if not (np.issubdtype(l.dtype, np.integer) and np.issubdtype(r.dtype, np.integer)):
        raise TypeError(f"query bounds must be integer arrays, got {l.dtype} / {r.dtype}")
    l = l.astype(np.int64)
    r = r.astype(np.int64)
    if l.size == 0:  # nothing to do: no phantom padded query, no launch
        return (
            torch.zeros(0, dtype=torch.int32, device=device),
            torch.zeros(0, dtype=out_dtype, device=device),
        )
    if int(l.min()) < 0 or int(r.max()) > _INT32_MAX:
        raise ValueError(
            f"query bounds [{int(l.min())}, {int(r.max())}] outside the engines' "
            "int32 index range"
        )
    short = (r - l + 1) <= threshold
    n_short = int(short.sum())
    cb = getattr(_split_sink, "cb", None)
    if cb is not None:
        cb(n_short, int(l.size - n_short))
    # Regime split onto the ambient trace span (the server's launch span
    # when tracing is on) — obs.set_attr is a no-op outside any span.
    if obs_trace.get_tracer().enabled:
        obs_trace.set_attr("split_short", n_short)
        obs_trace.set_attr("split_long", int(l.size - n_short))

    # Every launch pads its batch to a power of two with (0, 0) queries, as
    # the reference does to bound its jit cache: the same launch shapes here.
    def _launch(fn, lm, rm):
        k = lm.size
        kp = 1 << (k - 1).bit_length() if k > 1 else 1
        lp = np.zeros(kp, np.int32)
        rp = np.zeros(kp, np.int32)
        lp[:k] = lm
        rp[:k] = rm
        qi, qv = fn(as_index(lp, device), as_index(rp, device))
        return qi, qv, k

    # Uniform batches skip the partition/scatter round-trip entirely.
    if n_short == short.size or n_short == 0:
        qi, qv, k = _launch(short_fn if n_short else long_fn, l, r)
        return qi[:k], qv[:k]

    # Mixed batch: launch both sub-batches, then bring both to the host (one
    # copy each) and scatter there.
    idx = np.empty(l.shape, np.int32)
    val = None
    launched = [
        (mask, _launch(fn, l[mask], r[mask]))
        for mask, fn in ((short, short_fn), (~short, long_fn))
    ]
    for mask, (qi, qv, k) in launched:
        qv = to_numpy(qv[:k])
        if val is None:
            val = np.empty(l.shape, qv.dtype)
        idx[mask] = to_numpy(qi[:k])
        val[mask] = qv
    return torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device)


def query(s: HybridRMQ, l, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range-adaptive batched RMQ. Returns (leftmost argmin idx int32, value).

    Bit-identical to ``block_rmq.query`` on the same batch.
    """
    return dispatch_by_length(l, r, s.threshold, s.short_fn, s.long_fn, s.x.dtype, s.x.device)
