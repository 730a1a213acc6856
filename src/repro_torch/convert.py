"""Carry structures built by the JAX package across to this package.

Each function takes a structure of the reference package whose leaves have
been turned into numpy arrays (any object with the reference's field names
will do: this module imports nothing of the reference) and returns the
port's structure on ``device``. Index leaves must be int32 and value leaves
keep x's dtype, so a structure built by the reference and queried by the
port answers exactly as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import block_rmq as _block_rmq
from repro_torch.core import hybrid as _hybrid
from repro_torch.core import sparse_table as _sparse_table

__all__ = ["block_rmq", "fused_rmq", "hybrid", "sparse_table"]


def _leaf(a, device, *, index: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    if index and a.dtype != np.int32:
        raise TypeError(f"index leaves must be int32, got {a.dtype}")
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a writable copy


def sparse_table(st, device=None) -> _sparse_table.SparseTable:
    """``SparseTable(idx, x)``."""
    dev = resolve(device)
    return _sparse_table.SparseTable(idx=_leaf(st.idx, dev, index=True), x=_leaf(st.x, dev))


def block_rmq(s, device=None) -> _block_rmq.BlockRMQ:
    """``BlockRMQ(x_blocks, bmin_val, bmin_gidx, st)``."""
    dev = resolve(device)
    return _block_rmq.BlockRMQ(
        x_blocks=_leaf(s.x_blocks, dev),
        bmin_val=_leaf(s.bmin_val, dev),
        bmin_gidx=_leaf(s.bmin_gidx, dev, index=True),
        st=sparse_table(s.st, dev),
    )


def fused_rmq(s, device=None):
    """``FusedRMQ``: ``BlockRMQ``'s leaves plus ``st_val``/``st_gidx``."""
    from repro_torch.kernels.ops import FusedRMQ

    dev = resolve(device)
    b = block_rmq(s, dev)
    return FusedRMQ(
        *b,
        st_val=_leaf(s.st_val, dev),
        st_gidx=_leaf(s.st_gidx, dev, index=True),
    )


def hybrid(h, device=None, *, use_kernels: bool | None = None) -> _hybrid.HybridRMQ:
    """``HybridRMQ`` from the reference's arrays (``blocked``, ``st``, ``x``)
    and its ``threshold``.

    ``use_kernels=None`` -> the kernels exactly when ``device`` is CUDA, as
    the port's own build decides, with the default kernel geometry. The
    kernel path needs the value-augmented tables; when the reference's
    ``blocked`` is a bare ``BlockRMQ`` they are derived here, once.
    """
    from repro_torch.kernels import ops, tuning
    from repro_torch.kernels.fused_query import interior_tables

    dev = resolve(device)
    if use_kernels is None:
        use_kernels = dev.type == "cuda"
    if hasattr(h.blocked, "st_val"):
        blocked = fused_rmq(h.blocked, dev)
    else:
        blocked = block_rmq(h.blocked, dev)
    cfg = None
    if use_kernels:
        if not isinstance(blocked, ops.FusedRMQ):
            tables = interior_tables(blocked.bmin_val, blocked.bmin_gidx, blocked.st.idx)
            blocked = ops.FusedRMQ(*blocked, *tables)
        cfg = tuning.default_config(blocked.x_blocks.shape[1])
    return _hybrid.assemble(
        blocked, sparse_table(h.st, dev), _leaf(h.x, dev), int(h.threshold), use_kernels, cfg
    )
