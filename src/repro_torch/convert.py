"""Carry structures built by the JAX package across to this package.

Each function takes a structure of the reference package whose leaves have
been turned into numpy arrays (any object with the reference's field names
will do: this module imports nothing of the reference) and returns the
port's structure on ``device``. Index leaves must be int32 and value leaves
keep x's dtype, so a structure built by the reference and queried by the
port answers exactly as the reference does. ``online_engine`` carries an
online engine's state across: the reference's ``OnlineEngine.snapshot()``
output resumes in the port at the same version. ``model_params`` and
``model_cache`` carry an LM's parameter tree and decode cache across, and
``opt_state`` its AdamW state.

The mesh structures (``distributed``, ``sharded_st``, ``sharded_hybrid``)
take the reference's *global* leaves and a port ``launch.mesh.Mesh``: each
leaf is split into per-shard tensors as the reference's ``PartitionSpec``
laid it out (``P(axis_names)``: the first dimension, ``P(None,
axis_names)``: the second), so the shard-local indices of the per-shard
blocked tables stay where they were built. A replicated leaf
(``shard_batch``) gets one copy per device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import block_rmq as _block_rmq
from repro_torch.core import distributed as _distributed
from repro_torch.core import hybrid as _hybrid
from repro_torch.core import packing as _packing
from repro_torch.core import sharded_hybrid as _sharded_hybrid
from repro_torch.core import sparse_table as _sparse_table

__all__ = [
    "block_rmq",
    "distributed",
    "fused_rmq",
    "hybrid",
    "model_cache",
    "model_params",
    "online_engine",
    "opt_state",
    "sharded_hybrid",
    "sharded_st",
    "sparse_table",
]


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


def online_engine(arrays, meta, device=None, *, mesh=None, axis_names=None):
    """An ``update.OnlineEngine`` resumed from ``OnlineEngine.snapshot()``
    output of either package: ``arrays`` (numpy leaves by name) and the JSON
    ``meta`` (engine, vid, n, dtype, build kwargs), unchanged. The engine
    continues at the snapshot's version id with the same answers and
    leaves; a single-device engine's mirrors are the snapshot's arrays, so
    no argmin is rebuilt. A mesh engine's snapshot is its array only: it is
    rebuilt on ``mesh`` (over ``axis_names``) with the snapshot's pinned
    build kwargs.
    """
    from repro_torch.update import OnlineEngine

    if int(meta["n"]) != np.asarray(arrays["x"]).shape[0]:
        raise ValueError(f"snapshot meta says n={meta['n']}, its x has {np.asarray(arrays['x']).shape[0]}")
    return OnlineEngine.from_snapshot(arrays, meta, device=device, mesh=mesh, axis_names=axis_names)


# --- mesh structures ---------------------------------------------------------


def _split(a, mesh, axes, dim: int, *, index: bool = False):
    a = np.asarray(a)
    if index and a.dtype != np.int32:
        raise TypeError(f"index leaves must be int32, got {a.dtype}")
    return _distributed.split_leaf(np.array(a, order="C"), mesh, axes, dim)


def _port_spec(spec):
    """A port ``PackSpec`` from either package's (same fields)."""
    return None if spec is None else _packing.PackSpec(*spec)


def _sharded_blocked(s, mesh, axes, spec):
    """A blocked structure sharded over ``axes`` (``()``: replicated):
    ``BlockRMQ`` leaves, or ``PackedBlockRMQ`` ones when ``spec`` is given."""
    if spec is not None:
        return _block_rmq.PackedBlockRMQ(
            blocks=_split(s.blocks, mesh, axes, 0), stw=_split(s.stw, mesh, axes, 1)
        )
    return _block_rmq.BlockRMQ(
        x_blocks=_split(s.x_blocks, mesh, axes, 0),
        bmin_val=_split(s.bmin_val, mesh, axes, 0),
        bmin_gidx=_split(s.bmin_gidx, mesh, axes, 0, index=True),
        st=_sparse_table.SparseTable(
            idx=_split(s.st.idx, mesh, axes, 1, index=True), x=_split(s.st.x, mesh, axes, 0)
        ),
    )


def distributed(s, mesh, axis_names=None, *, spec=None):
    """The ``distributed`` engine's state ``(structure, query_fn)`` from the
    reference's ``build_sharded`` leaves (``build_sharded_packed``'s with
    ``spec``, the ``PackSpec`` it was packed with), sharded over
    ``axis_names`` (default: every axis of ``mesh``)."""
    axes = tuple(axis_names or mesh.axis_names)
    spec = _port_spec(spec)
    if spec is not None:
        qfn = _distributed.make_packed_query_fn(mesh, axes, spec)
    else:
        qfn = _distributed.make_query_fn(mesh, axes)
    return _sharded_blocked(s, mesh, axes, spec), qfn


def sharded_st(t, mesh, axis_names=None) -> _distributed.ShardedSparseTable:
    """``ShardedSparseTable(idx, val)``, column-sharded over ``axis_names``."""
    axes = tuple(axis_names or mesh.axis_names)
    return _distributed.ShardedSparseTable(
        idx=_split(t.idx, mesh, axes, 1, index=True), val=_split(t.val, mesh, axes, 1)
    )


def sharded_hybrid(h, mesh, axis_names=None, *, spec=None) -> _sharded_hybrid.ShardedHybridRMQ:
    """``ShardedHybridRMQ`` from the reference's (``blocked``, ``st``, ``n``,
    ``threshold``, ``mode``, ``dtype``) over ``mesh``, its query paths those
    of ``h.mode``. A packed build needs its ``PackSpec`` as ``spec`` (the
    reference's structure does not carry it)."""
    from repro_torch.core.build import _mode_axes

    axes = tuple(axis_names or mesh.axis_names)
    struct_axes, _ = _mode_axes(h.mode, axes)
    spec = _port_spec(spec)
    blocked = _sharded_blocked(h.blocked, mesh, struct_axes, spec)
    if spec is not None:
        st = _sparse_table.PackedSparseTable(words=_split(h.st.words, mesh, struct_axes, 1))
    elif struct_axes:
        st = sharded_st(h.st, mesh, struct_axes)
    else:
        st = _sparse_table.SparseTable(idx=_split(h.st.idx, mesh, (), 1, index=True), x=_split(h.st.x, mesh, (), 0))
    return _sharded_hybrid.assemble(
        blocked,
        st,
        n=h.n,
        threshold=h.threshold,
        mode=h.mode,
        mesh=mesh,
        axis_names=axes,
        dtype=torch.from_numpy(np.zeros(0, np.dtype(h.dtype))).dtype,
        spec=spec,
    )


# --- the LM substrate ---------------------------------------------------------


def _model_leaf(a, device, dtype) -> torch.Tensor:
    """A reference leaf as a tensor. A bfloat16 numpy leaf (ml_dtypes, which
    JAX registers in the caller's process) is read through float32, which
    holds every bfloat16 value exactly, and keeps bfloat16 unless ``dtype``
    says otherwise."""
    a = np.asarray(a)
    want = dtype
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
        want = dtype or torch.bfloat16
    t = torch.from_numpy(np.array(a, order="C")).to(device)
    return t if want is None else t.to(want)


def model_params(params, device=None, dtype=None) -> dict:
    """The port's parameter tree from the reference's nested dict of numpy
    leaves (same paths), on ``device``, cast to ``dtype`` when given."""
    dev = resolve(device)
    return {
        k: model_params(v, dev, dtype) if isinstance(v, dict) else _model_leaf(v, dev, dtype)
        for k, v in params.items()
    }


def model_cache(cache, device=None):
    """The port's decode ``Cache`` from the reference's (numpy leaves, or
    None where a family has no such slot); ``length`` becomes an int."""
    from repro_torch.models.transformer import Cache

    dev = resolve(device)
    leaf = {
        f: None if getattr(cache, f) is None else _model_leaf(getattr(cache, f), dev, None)
        for f in ("k", "v", "conv", "ssd")
    }
    return Cache(length=int(np.asarray(cache.length)), **leaf)


def opt_state(state, device=None, dtype=None):
    """The port's ``optim.AdamWState`` from the reference's (numpy leaves):
    ``step`` stays an int32 0-d tensor, ``master``/``mu``/``nu`` are
    parameter trees (cast to ``dtype`` when given)."""
    from repro_torch.optim.adamw import AdamWState

    dev = resolve(device)
    step = np.asarray(state.step)
    if step.dtype != np.int32 or step.shape != ():
        raise TypeError(f"AdamWState.step must be a 0-d int32, got {step.dtype} {step.shape}")
    return AdamWState(
        step=torch.from_numpy(np.array(step)).to(dev),
        master=model_params(state.master, dev, dtype),
        mu=model_params(state.mu, dev, dtype),
        nu=model_params(state.nu, dev, dtype),
    )
