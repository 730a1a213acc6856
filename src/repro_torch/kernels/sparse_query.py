"""Doubling-table RMQ query: wrapper and plain version.

``sparse_query`` answers a batch of RMQs over a ``core.sparse_table`` index
table in one launch of the CUDA kernel of ``csrc/sparse_query.cu`` for CUDA
tensors, and runs ``sparse_query_plain`` for CPU tensors. The kernel
replaces no Pallas kernel (the reference's sparse table is jnp ops); it
replaces the chain of torch ops of ``core.sparse_table.query`` and the value
gather, which the hybrid engine's long path ran. Both return the same bits.
The source note of the kernel gives its bound and design.

Each launch adds its batch size to the counter
``sparse_query_queries_total{layout="unpacked"}`` of
``obs.metrics.default_registry()`` (plain calls add nothing).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core import sparse_table
from repro_torch.obs.metrics import default_registry

from . import _build

__all__ = ["sparse_query", "sparse_query_plain"]

_ENTRY = {torch.float32: "repro_sparse_query_f32", torch.int32: "repro_sparse_query_i32"}
_INT32_MAX = 2**31 - 1
_count_lock = threading.Lock()


def sparse_query_plain(idx_table: torch.Tensor, x: torch.Tensor, l: torch.Tensor, r: torch.Tensor):
    """``core.sparse_table.query`` (``exact_log2``, the two cells, the
    leftmost pick) and the value gather ``x[idx]``, as torch ops."""
    idx = sparse_table.query(sparse_table.SparseTable(idx=idx_table, x=x), l, r)
    return idx, x[idx]


def _check(idx_table, x, l, r) -> None:
    what = "sparse_query"
    if idx_table.dtype != torch.int32 or idx_table.ndim != 2 or not idx_table.is_contiguous():
        raise ValueError(
            f"{what}: idx_table must be a contiguous 2-D int32 tensor, got {idx_table.dtype} "
            f"{tuple(idx_table.shape)}"
        )
    if x.dtype not in _ENTRY:
        raise TypeError(f"{what} takes float32 or int32 values, got {x.dtype}")
    if x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous 1-D tensor, got {tuple(x.shape)}")
    n = x.shape[0]
    if not 1 <= n <= _INT32_MAX or idx_table.shape[1] != n:
        raise ValueError(f"{what}: idx_table {tuple(idx_table.shape)} does not index x of {n} values")
    if idx_table.shape[0] < n.bit_length():
        raise ValueError(
            f"{what}: idx_table has {idx_table.shape[0]} levels, a range of {n} values needs "
            f"{n.bit_length()}"
        )
    for name, t in (("l", l), ("r", r)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or t.ndim != 1:
            raise ValueError(f"{what}: {name} must be a 1-D int32 tensor, got {getattr(t, 'dtype', type(t))}")
    if l.shape != r.shape or l.shape[0] > _INT32_MAX:
        raise ValueError(f"{what}: l/r must have equal shapes, got {tuple(l.shape)} / {tuple(r.shape)}")
    devices = {t.device for t in (idx_table, x, l, r)}
    if len(devices) != 1:
        raise ValueError(f"{what}: idx_table, x, l and r must share one device, got {sorted(map(str, devices))}")


def sparse_query(
    idx_table: torch.Tensor,  # (K, n) int32: core.sparse_table.SparseTable.idx
    x: torch.Tensor,  # (n,) float32 | int32, the values the table indexes
    l: torch.Tensor,  # (B,) int32 bounds, 0 <= l <= r < n
    r: torch.Tensor,
):
    """Batched doubling-table RMQ. Returns (leftmost argmin idx (B,) int32,
    value (B,)), bit for bit those of :func:`sparse_query_plain`.

    One kernel launch per batch on the card; the plain version for CPU
    tensors. Raises on anything the kernel does not take (there is no
    fallback).
    """
    _check(idx_table, x, l, r)
    dev = x.device
    if dev.type == "cpu":
        return sparse_query_plain(idx_table, x, l, r)
    if dev.type != "cuda":
        raise ValueError(f"sparse_query runs on cuda or cpu tensors, got {dev}")
    l = l.contiguous()
    r = r.contiguous()
    b = l.shape[0]
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    val = torch.empty(b, dtype=x.dtype, device=dev)
    if b == 0:
        return idx, val
    _build.launch(
        _ENTRY[x.dtype], "sparse_query", dev,
        idx_table.data_ptr(), x.data_ptr(), l.data_ptr(), r.data_ptr(), idx.data_ptr(),
        val.data_ptr(), b, x.shape[0],
    )
    with _count_lock:
        sparse_query.launches += 1
    default_registry().counter("sparse_query_queries_total", layout="unpacked").inc(b)
    return idx, val


sparse_query.launches = 0  # kernel launches since the last reset (plain calls do not count)
