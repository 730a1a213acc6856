"""RMQ sharded across the positions of a device mesh.

Each structure shard owns a contiguous chunk of the array with its own
local structure and answers the query restricted to its chunk; the shards
merge with two min-reductions (value min, then the leftmost index among the
shards holding it), exact leftmost semantics from min alone.

The mesh is driven by one process (``launch.mesh``): where the reference
runs one ``shard_map`` program per device, this module loops over the
shards, and the reference's collectives become tensor operations over the
per-shard results (``pmin``: a reduction over the shard axis;
``ppermute``'s halo: indexing into the tuple of shards). A sharded leaf is
a ``ShardedLeaf``: one tensor per structure shard, with one copy on each
device that serves the shard, shared by the mesh positions that sit on that
device. ``ShardedLeaf.full()`` concatenates the global view the reference's
``PartitionSpec`` describes; no query path uses it. ``Placement`` is the
port's ``NamedSharding``: how ``split_leaf`` lays a global array over a
mesh axis (``checkpoint.restore(shardings=)`` takes it).

Three distribution strategies, as in the reference:

* **structure-sharded** (``build_sharded`` / ``build_sharded_st`` +
  ``make_query_fn`` / ``make_st_query_fn``): the array is sharded, every
  shard answers every query, and the shards merge with the two-min trick.
* **batch-sharded** (``build_replicated`` / ``build_replicated_st`` + the
  same factories with ``batch_sharded=True``): the structure is replicated
  and each mesh position answers its slice of the (zero-padded) batch.
* **2D** (``batch_axes=...``): the structure is sharded over
  ``axis_names`` and the batch over the disjoint ``batch_axes``; each batch
  slice is answered by one structure-shard group.

Positions that share a device and a structure shard answer their batch
slices in one call. The column-sharded doubling table (``ShardedSparseTable``)
is built per shard with a level-k halo exchange of boundary columns
(``st_local_level0`` + ``st_halo_doubling``), each level written into a
preallocated ``(K, C)`` table per shard, so no device ever holds the full
``(K, n)`` table. The online patches (``patch_sharded``,
``patch_sharded_st`` and their packed twins) repair each shard's windows
copy-on-write through the same halo transport. Port of
``repro/core/distributed.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import as_index

from . import block_rmq, packing, sparse_table
from .block_rmq import BlockRMQ, PackedBlockRMQ, maxval
from .sparse_table import PackedSparseTable, SparseTable

__all__ = [
    "Placement",
    "ShardedLeaf",
    "ShardedSparseTable",
    "build_replicated",
    "build_replicated_packed",
    "build_replicated_st",
    "build_replicated_st_packed",
    "build_sharded",
    "build_sharded_packed",
    "build_sharded_st",
    "build_sharded_st_packed",
    "home_device",
    "make_packed_query_fn",
    "make_packed_st_query_fn",
    "make_query_fn",
    "make_st_query_fn",
    "num_shards",
    "pack_global",
    "patch_sharded",
    "patch_sharded_packed",
    "patch_sharded_st",
    "patch_sharded_st_packed",
    "shard",
    "shard_devices",
    "shard_rows",
    "split_leaf",
    "st_halo_doubling",
    "st_halo_doubling_packed",
    "st_levels",
    "st_local_level0",
]

_INT_BIG = 2**31 - 1


def num_shards(mesh, axis_names: Sequence[str]) -> int:
    """Product of the given mesh axes — the flattened shard count."""
    num = 1
    for a in axis_names:
        num *= mesh.shape[a]
    return num


def home_device(mesh) -> torch.device:
    """The device of the mesh's first position: inputs land and answers
    come back there."""
    return mesh.devices.flat[0]


def _flat_index(mesh, pos, axis_names: Sequence[str]) -> int:
    """Flattened index of mesh position ``pos`` over ``axis_names``, in
    their given order (the reference's ``_flat_axis_index``)."""
    idx = 0
    for name in axis_names:
        idx = idx * mesh.shape[name] + pos[mesh.axis_names.index(name)]
    return idx


def shard_devices(mesh, axis_names: Sequence[str]) -> List[Tuple[torch.device, ...]]:
    """Per structure shard over ``axis_names``, the distinct devices of the
    positions that hold it (replicas along the other axes), in mesh order;
    the first is where the shard is built."""
    out = [dict() for _ in range(num_shards(mesh, axis_names))]
    for pos in np.ndindex(mesh.devices.shape):
        out[_flat_index(mesh, pos, axis_names)].setdefault(mesh.devices[pos])
    return [tuple(d) for d in out]


class ShardedLeaf:
    """One array of a mesh structure: a tensor per structure shard.

    ``copies[s]`` maps each device that serves shard ``s`` to the shard's
    tensor there; mesh positions on one device share that copy, so a card
    holds each shard once however many positions it hosts. In the global
    view the shards concatenate along ``dim``, as the reference's
    ``PartitionSpec`` lays them out; a replicated leaf has one shard.
    """

    __slots__ = ("copies", "dim")

    def __init__(self, copies, dim: int = 0):
        self.copies = tuple(copies)
        self.dim = dim

    @property
    def num_shards(self) -> int:
        return len(self.copies)

    def part(self, s: int, device=None) -> torch.Tensor:
        """Shard ``s``'s tensor on ``device`` (default: where it was built)."""
        copies = self.copies[s]
        return next(iter(copies.values())) if device is None else copies[device]

    @property
    def dtype(self) -> torch.dtype:
        return self.part(0).dtype

    @property
    def shape(self) -> tuple:
        shape = list(self.part(0).shape)
        shape[self.dim] = sum(self.part(s).shape[self.dim] for s in range(self.num_shards))
        return tuple(shape)

    def full(self) -> torch.Tensor:
        """The global view on the first shard's device (a copy unless the
        leaf has one shard)."""
        parts = [self.part(s) for s in range(self.num_shards)]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(parts[0].device) for p in parts], dim=self.dim)

    def __array__(self, dtype=None, copy=None):
        a = self.full().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        devs = sorted({str(d) for c in self.copies for d in c})
        return f"ShardedLeaf(shape={self.shape}, dtype={self.dtype}, shards={self.num_shards}, dim={self.dim}, devices={devs})"


def _map(fn, tree, *others):
    """``fn`` over the leaves of NamedTuple ``tree`` (and the same leaves
    of ``others``); ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, *sub) for sub in zip(tree, *others)))
    return fn(tree, *others)


def _join(parts: list, dims, devs) -> object:
    """One structure of ``ShardedLeaf`` from per-shard structures
    (``parts[s]`` built on ``devs[s][0]``), each shard copied to the rest of
    its devices; ``dims`` gives each leaf's concatenation dimension."""

    def leaf(dim, *tensors):
        return ShardedLeaf(
            ({d: t if t.device == d else t.to(d) for d in devs[s]} for s, t in enumerate(tensors)), dim
        )

    return _map(leaf, dims, *parts)


def shard(tree, s: int, device=None):
    """Shard ``s``'s tensors of a ``ShardedLeaf`` structure, on ``device``
    (default: where the shard was built)."""
    return _map(lambda leaf: leaf.part(s, device), tree)


def split_leaf(a, mesh, axis_names: Sequence[str], dim: int = 0) -> ShardedLeaf:
    """A global array (numpy or tensor) split into equal shards over
    ``axis_names`` along ``dim`` and placed on the mesh (``axis_names=()``
    replicates it)."""
    devs = shard_devices(mesh, axis_names)
    t = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    pieces = torch.chunk(t, len(devs), dim=dim) if len(devs) > 1 else (t,)
    if len(pieces) != len(devs) or len({p.shape[dim] for p in pieces}) != 1:
        raise ValueError(f"dimension {dim} of shape {tuple(t.shape)} does not split into {len(devs)} equal shards")
    return ShardedLeaf(({d: p.contiguous().to(d) for d in ds} for p, ds in zip(pieces, devs)), dim)


@dataclass(frozen=True)
class Placement:
    """Where a global array goes on a mesh: split into equal shards over
    ``axis_names`` along ``dim`` (``()``: replicated), the port's
    counterpart of the reference's ``NamedSharding``. Not a tuple, so a
    tree of placements flattens with one leaf per placement."""

    mesh: object
    axis_names: Tuple[str, ...] = ()
    dim: int = 0

    def place(self, a) -> ShardedLeaf:
        return split_leaf(a, self.mesh, tuple(self.axis_names), self.dim)


# Concatenation dimension of every leaf in the global view: the reference's
# out_specs (P(axis_names) -> 0, P(None, axis_names) -> 1).
_BLOCK_DIMS = BlockRMQ(0, 0, 0, SparseTable(1, 0))
_PACKED_BLOCK_DIMS = PackedBlockRMQ(0, 1)


def _shard_len(n: int, num: int, block_size: int = 1) -> int:
    """Columns per shard: ``n`` padded to a multiple of ``num * block_size``."""
    return -(-max(n, 1) // (num * block_size)) * block_size


def shard_rows(v: torch.Tensor, mesh, axis_names: Sequence[str], shard_len: int, fill=None) -> ShardedLeaf:
    """``v`` padded with ``fill`` to ``shard_len`` columns per shard over
    ``axis_names``, each shard's columns on the device that builds it (a
    view of ``v`` where they lie inside it and on its device)."""
    devs = shard_devices(mesh, axis_names)
    n = v.shape[0]
    parts = []
    for s, ds in enumerate(devs):
        lo, hi = s * shard_len, (s + 1) * shard_len
        if hi <= n:
            part = v[lo:hi].to(ds[0])
        else:
            part = torch.full((shard_len,), fill, dtype=v.dtype, device=ds[0])
            if lo < n:
                part[: n - lo] = v[lo:]
        parts.append({ds[0]: part})
    return ShardedLeaf(parts, 0)


def build_sharded(x, mesh, axis_names: Sequence[str], block_size: int) -> BlockRMQ:
    """Per-shard blocked structures; leaves are sharded on the block dim.

    The BuildPlan "local build" stage of the mesh engines: each shard runs
    ``block_rmq.build`` over its chunk of the padded array on its device, no
    communication. Index leaves are shard-local, as in the reference.
    """
    axis_names = tuple(axis_names)
    devs = shard_devices(mesh, axis_names)
    x = torch.as_tensor(x)
    rows = shard_rows(x, mesh, axis_names, _shard_len(x.shape[0], len(devs), block_size), maxval(x.dtype))
    parts = [block_rmq.build(rows.part(s), block_size, device=ds[0]) for s, ds in enumerate(devs)]
    return _join(parts, _BLOCK_DIMS, devs)


def build_replicated(x, mesh, block_size: int) -> BlockRMQ:
    """Full blocked structure, one copy on each of the mesh's devices
    (batch-sharded mode)."""
    devs = shard_devices(mesh, ())
    return _join([block_rmq.build(x, block_size, device=devs[0][0])], _BLOCK_DIMS, devs)


def _pad_batch(l, r, num: int):
    """Pad a query batch with trivial (0, 0) queries to a multiple of ``num``."""
    b = l.shape[0]
    bp = -(-b // num) * num
    if bp == b:
        return l, r, b
    z = torch.zeros(bp - b, dtype=l.dtype, device=l.device)
    return torch.cat([l, z]), torch.cat([r, z]), b


def _check_batch_axes(axis_names, batch_axes, batch_sharded):
    """Normalize/validate the 2D-mode batch axes (disjoint from structure)."""
    batch_axes = tuple(batch_axes or ())
    if batch_axes and batch_sharded:
        raise ValueError("batch_axes is the 2D mode; batch_sharded shards over "
                         "ALL axes — pass one or the other")
    overlap = set(batch_axes) & set(axis_names)
    if overlap:
        raise ValueError(f"batch_axes {sorted(overlap)} overlap the structure axes")
    return batch_axes


def _spmd(mesh, struct_axes, batch_axes, local_fn: Callable, merge_fn: Callable):
    """The port of ``shard_map``: ``(structure, l, r) -> merge_fn(outs)``.

    Every mesh position answers its batch slice (over ``batch_axes``; the
    whole batch when there are none) against its structure shard (over
    ``struct_axes``) through ``local_fn(local, s, l, r) -> tuple of tensors``
    whose last dimension is the batch. Positions that repeat a (shard,
    slice) pair answer nothing new; those that share a shard and a device
    answer their slices in one call. ``merge_fn`` gets, per structure
    shard, its outputs over the whole batch on the mesh's home device (the
    batch length must divide by the batch-slice count).
    """
    home = home_device(mesh)
    num_s = num_shards(mesh, struct_axes)
    num_g = num_shards(mesh, batch_axes)
    first = {}
    for pos in np.ndindex(mesh.devices.shape):
        key = (_flat_index(mesh, pos, struct_axes), _flat_index(mesh, pos, batch_axes))
        first.setdefault(key, mesh.devices[pos])
    work = {}
    for (s, g), dev in first.items():
        work.setdefault((s, dev), []).append(g)

    def run(tree, l, r):
        bg = l.shape[0] // num_g
        outs = [[None] * num_g for _ in range(num_s)]
        for (s, dev), gs in work.items():
            if gs == list(range(num_g)):
                ql, qr = l, r
            else:
                ql = torch.cat([l[g * bg : (g + 1) * bg] for g in gs])
                qr = torch.cat([r[g * bg : (g + 1) * bg] for g in gs])
            res = local_fn(shard(tree, s, dev), s, ql.to(dev), qr.to(dev))
            for j, g in enumerate(gs):
                outs[s][g] = [t[..., j * bg : (j + 1) * bg].to(home) for t in res]
        per_shard = [
            tuple(row[0][i] if num_g == 1 else torch.cat([o[i] for o in row], dim=-1) for i in range(len(row[0])))
            for row in outs
        ]
        return merge_fn(per_shard)

    return run


def _sharded_query(mesh, struct_axes, batch_axes, local_fn, merge_fn=lambda outs: outs[0]):
    """``(structure, l, r) -> (idx, val)`` on the home device: the batch
    zero-padded to a multiple of the batch slices, ``_spmd``, the padding
    cut off. Batch-sharded: no structure axes (a replicated structure) and
    no merge; structure-sharded: every shard answers and ``merge_fn``
    combines them."""
    inner = _spmd(mesh, struct_axes, batch_axes, local_fn, merge_fn)
    nb = num_shards(mesh, batch_axes)
    home = home_device(mesh)

    def fn(s, l, r):
        lp, rp, b = _pad_batch(as_index(l, home), as_index(r, home), nb)
        idx, val = inner(s, lp, rp)
        return idx[:b], val[:b]

    return fn


def _replicated(local_fn):
    """A batch-sharded local query: the shard index is not needed."""
    return lambda t, shard, l, r: local_fn(t, l, r)


def _leftmost_merge(outs):
    """The two-pmin merge of per-shard ``(val, gidx)``: the value min, then
    the least index among the shards holding it. On equal values the value
    of the first such shard wins, as XLA's cross-device min keeps the lower
    shard's zero of +0.0 and -0.0; it is the value at the answer's index."""
    vmin = outs[0][0]
    for v, _ in outs[1:]:
        vmin = torch.where(v < vmin, v, vmin)
    imin = None
    for v, gidx in outs:
        cand = torch.where(v == vmin, gidx, _INT_BIG)
        imin = cand if imin is None else torch.minimum(imin, cand)
    return imin, vmin


def make_query_fn(mesh, axis_names: Sequence[str], *, batch_sharded: bool = False, batch_axes=None):
    """Distributed batched blocked query: ``(BlockRMQ, l, r) -> (idx, val)``.

    ``batch_sharded=False`` (default): the structure is sharded
    (``build_sharded``), every shard answers every query against its chunk,
    and the shards merge with the two-pmin trick. ``batch_sharded=True``:
    the structure is replicated (``build_replicated``) and each position
    answers its slice of the batch. ``batch_axes=...`` (2D): the structure
    stays sharded over ``axis_names`` and the batch is split over the
    disjoint ``batch_axes``. Answers land on the mesh's home device.
    """
    axis_names = tuple(axis_names)
    batch_axes = _check_batch_axes(axis_names, batch_axes, batch_sharded)
    if batch_sharded:
        return _sharded_query(mesh, (), axis_names, _replicated(block_rmq.query))

    def local_query(s: BlockRMQ, shard, l, r):
        nb, bs = s.x_blocks.shape
        local_n = nb * bs
        off = shard * local_n
        has = (r >= off) & (l <= off + local_n - 1)
        ql = torch.clamp(l - off, 0, local_n - 1)
        qr = torch.clamp(r - off, 0, local_n - 1)
        idx, val = block_rmq.query(s, ql, qr)
        val = torch.where(has, val, maxval(val.dtype))
        gidx = torch.where(has, idx + off, _INT_BIG)
        return val, gidx

    return _sharded_query(mesh, axis_names, batch_axes, local_query, _leftmost_merge)


# --- the column-sharded doubling table ---------------------------------------


class ShardedSparseTable(NamedTuple):
    """Globally-built doubling table, column-sharded over the mesh.

    Built over the *full* array and sharded by column, so any O(1) window
    lookup is answered by exactly the shard owning that column. ``val``
    materializes ``x[idx]`` so a lookup never needs a cross-shard gather.
    """

    idx: ShardedLeaf  # (K, n_pad) int32 leftmost argmin per doubling window
    val: ShardedLeaf  # (K, n_pad) the corresponding window-min values


_ST_DIMS = ShardedSparseTable(1, 1)


def st_levels(n_pad: int) -> int:
    """Doubling-table depth for a length-``n_pad`` array (matches
    ``sparse_table.build`` exactly — bit-identity depends on it)."""
    return max(1, (n_pad - 1).bit_length() + 1) if n_pad > 1 else 1


def st_local_level0(xp: ShardedLeaf, mesh, axis_names: Sequence[str]):
    """BuildPlan "local build" stage: per-shard level-0 ``(idx, val)`` rows.

    ``xp`` holds each shard's columns of the padded array; each shard
    computes its trivial level-0 row (global index + value) with no
    communication.
    """
    del mesh, axis_names  # the shards of xp already sit where they are built
    shard_len = xp.part(0).shape[0]
    idx = []
    for s in range(xp.num_shards):
        dev = xp.part(s).device
        idx.append({dev: torch.arange(s * shard_len, (s + 1) * shard_len, dtype=torch.int32, device=dev)})
    return ShardedLeaf(idx, 0), xp


def _columns(rows: list, lo: int, hi: int, last: torch.Tensor, device) -> torch.Tensor:
    """Global columns ``[lo, hi)`` of a row split into equal shards
    (``rows[s]`` on its own device), read from the shards that own them (the
    halo) onto ``device``; columns past the end take ``last`` (the tail
    clamp)."""
    shard_len = rows[0].shape[0]
    n_pad = shard_len * len(rows)
    pieces = []
    c = lo
    while c < min(hi, n_pad):
        s, off = divmod(c, shard_len)
        e = min(hi, (s + 1) * shard_len)
        pieces.append(rows[s][off : off + e - c].to(device))
        c = e
    if hi > max(lo, n_pad):
        pieces.append(last.to(device).expand(hi - max(lo, n_pad)))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _halo_levels(tables: list, n_pad: int, pick: Callable) -> None:
    """Fill rows 1..K-1 of every shard's ``(K, C)`` planes (row 0 filled):
    level k merges the previous row with itself shifted left by
    ``h = 2^(k-1)``, whose columns for shard ``s`` lie in shards ``s + h//C``
    and ``s + h//C + 1`` (past the last shard: the tail clamp). ``pick(prev, win, out)`` writes one level of one
    shard from per-plane rows."""
    k_levels, shard_len = tables[0][0].shape
    for k in range(1, k_levels):
        h = 1 << (k - 1)
        if h >= n_pad:  # the window spans the whole array: rows repeat
            for planes in tables:
                for p in planes:
                    p[k] = p[k - 1]
            continue
        prev = [[planes[j][k - 1] for planes in tables] for j in range(len(tables[0]))]
        last = [rows[-1][-1] for rows in prev]
        for s, planes in enumerate(tables):
            dev = planes[0].device
            c0 = s * shard_len
            win = [_columns(rows, c0 + h, c0 + h + shard_len, last[j], dev) for j, rows in enumerate(prev)]
            pick([rows[s] for rows in prev], win, [p[k] for p in planes])


def _pick_left(prev, win, out) -> None:
    """The leftmost-tie pick: prefer the unshifted (left) row on ties."""
    (pi, pv), (wi, wv), (oi, ov) = prev, win, out
    take = pv <= wv
    torch.where(take, pi, wi, out=oi)
    torch.where(take, pv, wv, out=ov)


def st_halo_doubling(idx0: ShardedLeaf, val0: ShardedLeaf, mesh, axis_names: Sequence[str]):
    """BuildPlan "halo exchange" stage: the distributed doubling recurrence.

    Each shard's ``(K, C)`` idx and val tables are allocated once, on the
    shard's device, and written level by level: the shifted operand of level
    k is read from the (one or two) shards that own it, columns past
    ``n_pad`` clamp to the previous row's last column, and the leftmost-tie
    pick (``val <= wv``) finishes the level. Per-device memory is O(K * C).
    Bit-identical to ``sparse_table.build`` on the same padded array.
    """
    axis_names = tuple(axis_names)
    devs = shard_devices(mesh, axis_names)
    num = len(devs)
    shard_len = idx0.part(0).shape[0]
    n_pad = num * shard_len
    k_levels = st_levels(n_pad)
    tables = []
    for s in range(num):
        i0, v0 = idx0.part(s), val0.part(s)
        ti = torch.empty((k_levels, shard_len), dtype=torch.int32, device=i0.device)
        tv = torch.empty((k_levels, shard_len), dtype=v0.dtype, device=v0.device)
        ti[0] = i0
        tv[0] = v0
        tables.append((ti, tv))
    _halo_levels(tables, n_pad, _pick_left)
    t = _join([ShardedSparseTable(ti, tv) for ti, tv in tables], _ST_DIMS, devs)
    return t.idx, t.val


def build_sharded_st(x, mesh, axis_names: Sequence[str]) -> ShardedSparseTable:
    """Distributed build of the column-sharded global doubling table.

    Lowers through the staged ``core.build`` pipeline (shard layout ->
    local build -> halo exchange -> finalize), bit-identical to
    ``sparse_table.build`` on the padded array; the full ``(K, n)`` table is
    never materialized anywhere.
    """
    from . import build as build_mod  # deferred: build sequences these stages

    x = torch.as_tensor(x)
    return build_mod.build("sharded_st", x, mesh=mesh, axis_names=axis_names)


def build_replicated_st(x, mesh) -> SparseTable:
    """Full doubling table, one copy on each of the mesh's devices
    (batch-sharded mode)."""
    devs = shard_devices(mesh, ())
    x = torch.as_tensor(x).to(devs[0][0])
    return _join([sparse_table.build(x)], SparseTable(1, 0), devs)


def _st_cells(t_planes, shard, l, r, fills):
    """The two window cells of each query on one shard's columns: the
    owner's cell, ``fills`` where another shard owns the column. Each plane
    gives a ``(2, B)`` tensor."""
    cols = t_planes[0].shape[1]
    c0 = shard * cols
    k = sparse_table.exact_log2(r - l + 1)
    cand = torch.stack([l, r - (1 << k) + 1])  # the two windows start at l and r - 2^k + 1
    owned = (cand >= c0) & (cand < c0 + cols)
    flat = k.to(torch.int64)[None, :] * cols + torch.clamp(cand - c0, 0, cols - 1)
    return [torch.where(owned, p.reshape(-1)[flat], f) for p, f in zip(t_planes, fills)]


def make_st_query_fn(mesh, axis_names: Sequence[str], *, batch_sharded: bool = False, batch_axes=None):
    """Distributed sparse-table query -> ``(idx, val)``.

    ``batch_sharded=False``: takes a ``ShardedSparseTable``. Each query
    needs two window lookups (columns ``l`` and ``r - 2^k + 1``); each column
    has one owner, so the others contribute maxval / INT32_MAX and a min
    over the shards recovers both candidates; the left window wins ties.
    ``batch_sharded=True``: takes a replicated ``SparseTable``
    (``build_replicated_st``) and each position answers its slice with the
    plain O(1) lookup and a value gather. ``batch_axes=...``: 2D, as in
    ``make_query_fn``.
    """
    axis_names = tuple(axis_names)
    batch_axes = _check_batch_axes(axis_names, batch_axes, batch_sharded)
    if batch_sharded:

        def local_st(t: SparseTable, l, r):
            idx = sparse_table.query(t, l, r)
            return idx, t.x[idx]

        return _sharded_query(mesh, (), axis_names, _replicated(local_st))

    def local_query(t: ShardedSparseTable, shard, l, r):
        return tuple(_st_cells((t.val, t.idx), shard, l, r, (maxval(t.val.dtype), _INT_BIG)))

    def merge(outs):
        v = torch.stack([o[0] for o in outs]).amin(dim=0)  # one owner per column
        i = torch.stack([o[1] for o in outs]).amin(dim=0)
        take_left = v[0] <= v[1]  # left window on ties -> exact leftmost
        return torch.where(take_left, i[0], i[1]), torch.where(take_left, v[0], v[1])

    return _sharded_query(mesh, axis_names, batch_axes, local_query, merge)


# --- packed (single-word-plane) distributed tier ----------------------------
#
# The packed tier moves ONE plane of order-isomorphic words (``core.packing``)
# through its halos and merges: the two-min leftmost merge collapses to one
# min, and the halo exchange reads one plane per level. Exact layouts only:
# the quantized layout's bucket-tie fallback gathers values across shards,
# so the planners reject it for mesh engines.


def pack_global(x: torch.Tensor, spec, n_pad: int) -> torch.Tensor:
    """Pack ``x`` with *global* indices and pad to ``n_pad`` with pad words.

    Packing precedes padding, so pads are the reserved ``pad_word`` (always
    lose a min) rather than an encodable maxval element.
    """
    n = x.shape[0]
    out = torch.full((n_pad,), packing.pad_word(spec), dtype=packing.word_dtype(spec), device=x.device)
    out[:n] = packing.pack(spec, x, torch.arange(n, dtype=torch.int32, device=x.device))
    return out


def build_sharded_packed(x, mesh, axis_names: Sequence[str], block_size: int, spec) -> PackedBlockRMQ:
    """Per-shard packed blocked structures (one word plane per tier).

    Words carry global indices, so shard merges need no index offsetting —
    the min word across shards is already the global answer.
    """
    axis_names = tuple(axis_names)
    devs = shard_devices(mesh, axis_names)
    x = torch.as_tensor(x)
    shard_len = _shard_len(x.shape[0], len(devs), block_size)
    rows = shard_rows(pack_global(x, spec, len(devs) * shard_len), mesh, axis_names, shard_len)
    parts = []
    for s in range(len(devs)):
        wb = rows.part(s).reshape(-1, block_size)
        parts.append(PackedBlockRMQ(blocks=wb, stw=sparse_table.doubling_min(wb.min(dim=1).values)))
    return _join(parts, _PACKED_BLOCK_DIMS, devs)


def build_replicated_packed(x, mesh, block_size: int, spec) -> PackedBlockRMQ:
    """Full packed blocked structure, one copy on each of the mesh's devices."""
    devs = shard_devices(mesh, ())
    s, _ = block_rmq.build_packed(x, block_size, spec=spec, device=devs[0][0])
    return _join([s], _PACKED_BLOCK_DIMS, devs)


def make_packed_query_fn(mesh, axis_names: Sequence[str], spec, *, batch_sharded=False, batch_axes=None):
    """Packed distributed query: ``(PackedBlockRMQ, l, r) -> (idx, val)``.

    Mirrors ``make_query_fn``'s three modes; the structure-sharded merge is
    ONE min over packed words instead of the two-min reduction, exact
    leftmost ties by word order.
    """
    axis_names = tuple(axis_names)
    batch_axes = _check_batch_axes(axis_names, batch_axes, batch_sharded)
    pad = packing.pad_word(spec)
    if batch_sharded:

        def local_bs(s: PackedBlockRMQ, l, r):
            w = block_rmq.query_words(spec, s.blocks, s.stw, l, r)
            return packing.unpack_idx(spec, w), packing.unpack_val(spec, w)

        return _sharded_query(mesh, (), axis_names, _replicated(local_bs))

    def local_query(s: PackedBlockRMQ, shard, l, r):
        nb, bs = s.blocks.shape
        local_n = nb * bs
        off = shard * local_n
        has = (r >= off) & (l <= off + local_n - 1)
        ql = torch.clamp(l - off, 0, local_n - 1)
        qr = torch.clamp(r - off, 0, local_n - 1)
        w = block_rmq.query_words(spec, s.blocks, s.stw, ql, qr)
        return (torch.where(has, w, pad),)

    def merge(outs):
        wmin = torch.stack([o[0] for o in outs]).amin(dim=0)
        return packing.unpack_idx(spec, wmin), packing.unpack_val(spec, wmin)

    return _sharded_query(mesh, axis_names, batch_axes, local_query, merge)


def st_halo_doubling_packed(w0: ShardedLeaf, mesh, axis_names: Sequence[str], spec) -> ShardedLeaf:
    """Packed distributed doubling: the halo recurrence on ONE word plane.

    ``w0`` holds each shard's packed level-0 columns. Bit-identical (after
    unpacking) to ``st_halo_doubling`` on the same data — the leftmost-tie
    pick is subsumed by word ``minimum``.
    """
    del spec  # the words order themselves
    axis_names = tuple(axis_names)
    devs = shard_devices(mesh, axis_names)
    shard_len = w0.part(0).shape[0]
    n_pad = len(devs) * shard_len
    tables = []
    for s in range(len(devs)):
        row = w0.part(s)
        t = torch.empty((st_levels(n_pad), shard_len), dtype=row.dtype, device=row.device)
        t[0] = row
        tables.append((t,))
    _halo_levels(tables, n_pad, lambda prev, win, out: torch.minimum(prev[0], win[0], out=out[0]))
    return _join([t for (t,) in tables], 1, devs)


def build_sharded_st_packed(x, mesh, axis_names: Sequence[str], spec) -> PackedSparseTable:
    """Distributed build of the column-sharded packed doubling table."""
    axis_names = tuple(axis_names)
    x = torch.as_tensor(x)
    shard_len = _shard_len(x.shape[0], num_shards(mesh, axis_names))
    w0 = shard_rows(pack_global(x, spec, num_shards(mesh, axis_names) * shard_len), mesh, axis_names, shard_len)
    return PackedSparseTable(words=st_halo_doubling_packed(w0, mesh, axis_names, spec))


def build_replicated_st_packed(x, mesh, spec) -> PackedSparseTable:
    """Full packed doubling table, one copy on each of the mesh's devices."""
    devs = shard_devices(mesh, ())
    x = torch.as_tensor(x).to(devs[0][0])
    t, _ = sparse_table.build_packed(x, spec=spec)
    return _join([t], PackedSparseTable(1, None), devs)


def make_packed_st_query_fn(mesh, axis_names: Sequence[str], spec, *, batch_sharded=False, batch_axes=None):
    """Packed distributed sparse-table query -> ``(idx, val)``: the owner
    merge is one min over a ``(2, B)`` word stack, and the left/right window
    pick a plain word ``minimum``."""
    axis_names = tuple(axis_names)
    batch_axes = _check_batch_axes(axis_names, batch_axes, batch_sharded)
    pad = packing.pad_word(spec)
    if batch_sharded:
        return _sharded_query(
            mesh, (), axis_names, _replicated(lambda t, l, r: sparse_table.query_packed(t, spec, l, r))
        )

    def local_query(t: PackedSparseTable, shard, l, r):
        return tuple(_st_cells((t.words,), shard, l, r, (pad,)))

    def merge(outs):
        w = torch.stack([o[0] for o in outs]).amin(dim=0)
        wm = torch.minimum(w[0], w[1])  # leftmost tie by word order
        return packing.unpack_idx(spec, wm), packing.unpack_val(spec, wm)

    return _sharded_query(mesh, axis_names, batch_axes, local_query, merge)


# --- online patches (the update subsystem's mesh side) ------------------------
#
# ``repro_torch.update`` mutates mesh structures under live traffic. Each
# structure shard takes the updates it owns, repairs only its touched blocks,
# and re-runs the doubling recurrence over the affected column window of
# every level: a level-k entry at column c covers [c, c + 2^k), so only
# c in [mn - 2^k + 1, mx] can change (mn, mx: the hull of the updates).
# Windows that straddle shards read the neighbours' patched previous-level
# row through the build's halo transport (``_columns``). Copy-on-write: a
# shard whose window is empty at every level keeps its tensors, shared with
# the previous version (which pinned readers may still hold); a shard that
# changes gets clones with its windows written into them. Every result is
# leaf for leaf equal to a from-scratch build of the mutated array.


def _updates(upd_pos, upd_val):
    """The coalesced changed positions (int64) and their values, on the host."""
    pos = np.asarray(upd_pos, np.int64)
    if pos.size == 0:
        raise ValueError("patch called with no updates")
    return pos, np.asarray(upd_val)


def _owned(pos: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Mask of the positions in ``[lo, hi)``."""
    return (pos >= lo) & (pos < hi)


def _scatter(row: torch.Tensor, local: np.ndarray, values: np.ndarray) -> None:
    """``row[local] = values`` on ``row``'s device, in ``row``'s dtype."""
    idx = torch.from_numpy(local).to(row.device)
    row[idx] = torch.as_tensor(values).to(device=row.device, dtype=row.dtype)


def _patch_levels(tables: list, pos: np.ndarray, level0: list, pick: Callable) -> list:
    """Copy-on-write windowed repair of column-sharded ``(K, C)`` planes.

    ``tables[s]`` is shard ``s``'s tuple of planes; ``level0[j]`` the new
    level-0 values of plane ``j`` at ``pos`` (``None``: a plane whose level 0
    never changes); ``pick(prev, win, out)`` one level's merge, as in the
    build. Returns the per-shard planes of the next version: the same tuple
    for an untouched shard, clones for a changed one.
    """
    num = len(tables)
    k_levels, shard_len = tables[0][0].shape
    n_pad = num * shard_len
    mn, mx = int(pos.min()), int(pos.max())
    reach = mn - ((1 << (k_levels - 1)) - 1)  # the top level's window start
    new, changed = [], []
    for s, planes in enumerate(tables):
        c0 = s * shard_len
        if c0 > mx or c0 + shard_len - 1 < reach:
            new.append(planes)
            continue
        planes = tuple(p.clone() for p in planes)
        own = _owned(pos, c0, c0 + shard_len)
        if own.any():
            for p, vals in zip(planes, level0):
                if vals is not None:
                    _scatter(p[0], pos[own] - c0, vals[own])
        new.append(planes)
        changed.append(s)
    for k in range(1, k_levels):
        h = 1 << (k - 1)
        if h >= n_pad:  # the window spans the whole array: rows repeat
            for s in changed:
                for p in new[s]:
                    p[k] = p[k - 1]
            continue
        prev = [[planes[j][k - 1] for planes in new] for j in range(len(new[0]))]
        last = [rows[-1][-1] for rows in prev]
        lo = mn - ((1 << k) - 1)
        for s in changed:
            c0 = s * shard_len
            a, b = max(c0, lo), min(c0 + shard_len - 1, mx)
            if a > b:
                continue
            dev = new[s][0].device
            cur = [rows[s][a - c0 : b - c0 + 1] for rows in prev]
            win = [_columns(rows, a + h, b + h + 1, last[j], dev) for j, rows in enumerate(prev)]
            pick(cur, win, [p[k, a - c0 : b - c0 + 1] for p in new[s]])
    return new


def _planes(leaves) -> list:
    """Per structure shard, the tuple of its tensors of ``leaves``."""
    return [tuple(leaf.part(s) for leaf in leaves) for s in range(leaves[0].num_shards)]


def _rejoin(planes: list, fields) -> tuple:
    """``ShardedLeaf``s like ``fields`` from the patched
    per-shard planes: an untouched shard keeps its copies; a changed one is
    copied from its build device to the rest of its devices."""
    out = []
    for j, leaf in enumerate(fields):
        copies = []
        for s, planes_s in enumerate(planes):
            t = planes_s[j]
            if t is leaf.part(s):
                copies.append(leaf.copies[s])
            else:
                copies.append({d: t if t.device == d else t.to(d) for d in leaf.copies[s]})
        out.append(ShardedLeaf(copies, leaf.dim))
    return tuple(out)


def patch_sharded_st(t: ShardedSparseTable, upd_pos, upd_val, mesh, axis_names: Sequence[str]) -> ShardedSparseTable:
    """Patch the column-sharded doubling table in place of a rebuild.

    ``upd_pos``/``upd_val`` are the coalesced changed positions and values
    (host arrays; appends within the padded capacity are updates at pad
    columns). Per level the doubling recurrence re-runs over the affected
    window with the leftmost-tie pick (``val <= wv``), reading the patched
    previous level of the shards to the right where a window straddles them.
    Equal to ``build_sharded_st`` on the mutated array, with no device ever
    holding the full table.
    """
    del mesh, axis_names  # the shards of t already sit where they are patched
    pos, val = _updates(upd_pos, upd_val)
    planes = _patch_levels(_planes((t.idx, t.val)), pos, [None, val], _pick_left)
    return ShardedSparseTable(*_rejoin(planes, (t.idx, t.val)))


def _patch_block_levels(st_idx: torch.Tensor, lo: int, hi: int, merge: Callable) -> None:
    """Windowed repair, in place, of a shard-local ``(K, nb)`` doubling table
    over block minima whose touched blocks span ``[lo, hi]``: level k
    rewrites columns ``[lo - 2^k + 1, hi]`` with ``merge(cur, shifted)``,
    the shift tail-clamped to the last column (per-shard tables never cross
    their chunk, so there is no transport)."""
    k_levels, nb = st_idx.shape
    for k in range(1, k_levels):
        h = 1 << (k - 1)
        if h >= nb:
            st_idx[k] = st_idx[k - 1]
            continue
        a = max(0, lo - ((1 << k) - 1))
        row = st_idx[k - 1]
        shifted = _columns([row], a + h, hi + h + 1, row[-1], row.device)
        st_idx[k, a : hi + 1] = merge(row[a : hi + 1], shifted)


def patch_sharded(s: BlockRMQ, upd_pos, upd_val, mesh, axis_names: Sequence[str]) -> BlockRMQ:
    """Patch the mesh-sharded blocked structure in place of a rebuild.

    Each shard scatters the updates it owns into a clone of its chunk,
    re-takes the leftmost minimum of each touched block once
    (``block_rmq.leftmost_min``, the build's own), and window-patches its
    local block-min doubling table. Shards owning no update keep their
    tensors. Equal to ``build_sharded`` on the mutated array, leaf for leaf.
    """
    del mesh, axis_names
    pos, val = _updates(upd_pos, upd_val)
    nb, bs = s.x_blocks.part(0).shape
    local_n = nb * bs
    fields = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx)
    planes = []
    for sh, (xb, bv, bg, si) in enumerate(_planes(fields)):
        own = _owned(pos, sh * local_n, (sh + 1) * local_n)
        if not own.any():
            planes.append((xb, bv, bg, si))
            continue
        lp = pos[own] - sh * local_n
        xb, bv, bg, si = xb.clone(), bv.clone(), bg.clone(), si.clone()
        _scatter(xb.view(-1), lp, val[own])
        tb = np.unique(lp // bs)
        tbt = torch.from_numpy(tb).to(xb.device)
        bmin, lidx = block_rmq.leftmost_min(xb[tbt])
        bv[tbt] = bmin
        bg[tbt] = tbt.to(torch.int32) * bs + lidx
        _patch_block_levels(si, int(tb[0]), int(tb[-1]), lambda cur, sh_: torch.where(bv[cur] <= bv[sh_], cur, sh_))
        planes.append((xb, bv, bg, si))
    xb, bv, bg, si = _rejoin(planes, fields)
    return BlockRMQ(x_blocks=xb, bmin_val=bv, bmin_gidx=bg, st=SparseTable(idx=si, x=bv))


def _pack_updates(pos: np.ndarray, val, spec) -> np.ndarray:
    """The update words, packed on the host with global indices: a packed32
    spec that cannot encode a value raises ``OverflowError`` here, before
    any device state is written."""
    return packing.pack_np(spec, val, pos.astype(np.int32))


def patch_sharded_st_packed(
    t: PackedSparseTable, upd_pos, upd_val, mesh, axis_names: Sequence[str], spec
) -> PackedSparseTable:
    """Windowed patch of the column-sharded packed doubling table: one word
    plane rides the halo transport, and the leftmost-tie pick is the word
    ``minimum``. Equal to ``build_sharded_st_packed`` on the mutated array.
    Raises ``OverflowError`` before touching device state when a packed32
    spec cannot encode a new value."""
    del mesh, axis_names
    pos, val = _updates(upd_pos, upd_val)
    words = _pack_updates(pos, val, spec)
    pick = lambda prev, win, out: torch.minimum(prev[0], win[0], out=out[0])
    planes = _patch_levels(_planes((t.words,)), pos, [words], pick)
    return PackedSparseTable(words=_rejoin(planes, (t.words,))[0])


def patch_sharded_packed(
    s: PackedBlockRMQ, upd_pos, upd_val, mesh, axis_names: Sequence[str], spec
) -> PackedBlockRMQ:
    """Windowed patch of the mesh-sharded packed blocked structure: scatter
    the owned words, re-min the touched blocks, window-repair the per-shard
    doubling plane, all on single word planes. Equal to
    ``build_sharded_packed`` on the mutated array; raises ``OverflowError``
    before touching device state when the spec cannot encode a value."""
    del mesh, axis_names
    pos, val = _updates(upd_pos, upd_val)
    words = _pack_updates(pos, val, spec)
    nb, bs = s.blocks.part(0).shape
    local_n = nb * bs
    planes = []
    for sh, (wb, stw) in enumerate(_planes((s.blocks, s.stw))):
        own = _owned(pos, sh * local_n, (sh + 1) * local_n)
        if not own.any():
            planes.append((wb, stw))
            continue
        lp = pos[own] - sh * local_n
        wb, stw = wb.clone(), stw.clone()
        _scatter(wb.view(-1), lp, words[own])
        tb = np.unique(lp // bs)
        tbt = torch.from_numpy(tb).to(wb.device)
        stw[0, tbt] = wb[tbt].min(dim=1).values
        _patch_block_levels(stw, int(tb[0]), int(tb[-1]), torch.minimum)
        planes.append((wb, stw))
    wb, stw = _rejoin(planes, (s.blocks, s.stw))
    return PackedBlockRMQ(blocks=wb, stw=stw)
