"""Sharded range-adaptive hybrid RMQ: the crossover, distributed.

``core.distributed``'s mesh-sharded blocked engine meets ``core.hybrid``'s
range-adaptive routing: a sharded deployment that still sends every query
to the structure of its regime.

    batch (l, r)
      └─ partition by range length vs threshold        (torch, on s.device)
           ├─ short sub-batch -> sharded blocked path  (two-min merge)
           └─ long sub-batch  -> sharded sparse table  (owner-column min)
      └─ exact leftmost scatter-back into batch order

Three distribution modes, one per scaling axis (plus the product):

* ``mode="shard_structure"`` (default): the *array* is sharded — per-shard
  blocked chunks for the short path, a column-sharded global doubling table
  for the long path; every shard answers every query and the shards merge.
* ``mode="shard_batch"``: the *query batch* is sharded — the structures are
  replicated (one copy per device) and each mesh position answers its slice.
* ``mode="shard_2d"``: both — the structure is sharded over the FIRST mesh
  axis and the batch over the others; each batch slice is answered by one
  structure-shard group. On a 1-axis mesh it degrades to
  ``shard_structure``.

Builds lower through the staged ``core.build`` BuildPlan pipeline (shard
layout -> local build -> halo exchange -> finalize). The routing threshold
(``build(threshold=...)``): ``None`` is the sqrt(n) default, as in
``hybrid.build``; ``"cached"`` reads the calibration cache (key v2: the mode
and the mesh shape) with the sqrt(n) fallback, never measuring;
``"calibrated"`` measures the sharded constituents on this mesh on a miss;
an int pins it. Answers equal ``block_rmq.query`` on the same batch and
land on the mesh's home device. Port of ``repro/core/sharded_hybrid.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from . import distributed
from .hybrid import dispatch_by_length

__all__ = ["MODES", "ShardedHybridRMQ", "assemble", "build", "query"]

MODES = ("shard_structure", "shard_batch", "shard_2d")


class ShardedHybridRMQ(NamedTuple):
    """Both distributed constituents plus routing/launch metadata."""

    blocked: object  # sharded (or replicated) BlockRMQ | PackedBlockRMQ — short path
    st: object  # ShardedSparseTable | PackedSparseTable (or replicated) — long path
    n: int  # logical array length (pre-padding)
    threshold: int  # range lengths <= threshold go to the blocked path
    mode: str  # "shard_structure" | "shard_batch" | "shard_2d"
    n_shards: int  # flattened mesh size (batch-pad granularity)
    dtype: torch.dtype  # value dtype of the answers
    short_fn: object  # (blocked, l, r) -> (idx, val)
    long_fn: object  # (st, l, r) -> (idx, val)
    device: torch.device  # where answers land: the mesh's home device
    spec: object = None  # the PackSpec both tiers were packed with; None unpacked


def query_fns(mesh, axis_names: Sequence[str], mode: str, spec=None):
    """The ``(short_fn, long_fn)`` pair of ``mode`` on ``mesh``; the packed
    variants close over the data-dependent ``PackSpec`` ``spec``."""
    from .build import _mode_axes  # deferred: build.py hosts the planner

    axis_names = tuple(axis_names)
    struct_axes, batch_axes = _mode_axes(mode, axis_names)
    if struct_axes:
        kw = dict(batch_axes=batch_axes or None)
        axes = struct_axes
    else:
        kw = dict(batch_sharded=True)
        axes = axis_names
    if spec is not None:
        return (
            distributed.make_packed_query_fn(mesh, axes, spec, **kw),
            distributed.make_packed_st_query_fn(mesh, axes, spec, **kw),
        )
    return distributed.make_query_fn(mesh, axes, **kw), distributed.make_st_query_fn(mesh, axes, **kw)


def assemble(blocked, st, *, n, threshold, mode, mesh, axis_names, dtype, spec=None) -> ShardedHybridRMQ:
    """A ``ShardedHybridRMQ`` over built (or converted) sharded parts."""
    short_fn, long_fn = query_fns(mesh, axis_names, mode, spec)
    return ShardedHybridRMQ(
        blocked=blocked,
        st=st,
        n=int(n),
        threshold=int(threshold),
        mode=mode,
        n_shards=distributed.num_shards(mesh, axis_names),
        dtype=dtype,
        short_fn=short_fn,
        long_fn=long_fn,
        device=distributed.home_device(mesh),
        spec=spec,
    )


def build(
    x,
    mesh=None,
    axis_names: Sequence[str] | None = None,
    block_size: int = 128,
    *,
    threshold: int | str | None = None,
    mode: str = "shard_structure",
    cache_path=None,
    packed=None,
    device=None,
) -> ShardedHybridRMQ:
    """Build both distributed constituents over ``mesh`` (default: the
    one-axis mesh of ``build.default_mesh(device)``).

    ``threshold``: an int pins the crossover; ``None`` is the sqrt(n)
    default (no cache); ``"cached"`` reads the calibration cache with the
    sqrt(n) fallback, never measuring; ``"calibrated"`` measures on a miss —
    timing the *sharded* constituents on this mesh and mode — and persists
    the result. ``packed`` builds both tiers over packed32/packed64 words
    (``"quantized"`` is single-host only and raises).
    """
    from . import build as build_mod  # deferred: build.py hosts the planner

    return build_mod.build(
        "sharded_hybrid",
        x,
        device=device,
        mesh=mesh,
        axis_names=axis_names,
        block_size=block_size,
        threshold=threshold,
        mode=mode,
        cache_path=cache_path,
        packed=packed,
    )


def query(s: ShardedHybridRMQ, l, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range-adaptive distributed batched RMQ -> (leftmost idx int32, value).

    Partition by range length on ``s.device``, per-regime *sharded*
    launches, ordered scatter-back — ``hybrid.dispatch_by_length`` with the sharded
    constituents closed over their states. Equal to ``block_rmq.query``.
    """
    return dispatch_by_length(
        l,
        r,
        s.threshold,
        lambda lm, rm: s.short_fn(s.blocked, lm, rm),
        lambda lm, rm: s.long_fn(s.st, lm, rm),
        s.dtype,
        s.device,
    )
