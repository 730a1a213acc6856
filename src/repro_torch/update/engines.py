"""Online engines: incremental mutation + MVCC versions per registry engine.

``make_online(name, x)`` wraps an ``updatable`` registry engine in an
``OnlineEngine``: the initial state is built through the engine's staged
BuildPlan, and every subsequent mutation lowers through the two online
stages (``core.build.update_plan``: ``apply_deltas`` -> ``publish``) instead
of a rebuild. Queries pin a version from the MVCC store and never block on
mutation; ``apply`` is serialized (one updater at a time), so version ids
are the consistency order.

Per-engine patch strategy. Single-device engines (``sparse_table``,
``block128``, ``block256``, ``hybrid``, ``packed_hybrid``): host numpy
mirrors (``update.patch``) take the windowed per-level doubling repair and
the O(bs) block-min repair, then the patched leaves are published as fresh
device tensors, copy-on-write at the leaf level: a publish clones the
previous leaf on its device and writes only the uploaded windows into the
clone. The hybrids pin the plain short path (``use_kernels=False``), as the
reference does: the fused kernels' structures are not patched in place, so
an online hybrid launches no CUDA kernel. Mesh engines (``distributed``,
``sharded_hybrid``, ``packed_sharded_hybrid``): the structure-sharded modes
patch on the devices through ``core.distributed``'s copy-on-write shard
patches; ``shard_batch`` patches host mirrors and re-uploads one copy per
device; a batch past the padded capacity (or one a packed32 spec cannot
encode) rebuilds. A mesh engine's snapshot is the logical array, and a
restore re-runs the BuildPlan with the resolved knobs pinned.

Every patched state is bit-identical to a from-scratch rebuild of the
mutated array, leaf for leaf. Port of ``repro/update/engines.py``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve, to_numpy
from repro_torch.core import block_rmq, distributed, hybrid, packing, registry, sparse_table
from repro_torch.core import build as build_mod
from repro_torch.core.block_rmq import BlockRMQ
from repro_torch.core.sparse_table import SparseTable
from repro_torch.obs import trace as obs_trace

from .deltas import DeltaBatch, DeltaLog, shard_batches
from .patch import BlockMirror, PackedBlockMirror, PackedSTMirror, STMirror
from .patch import packed_fit_check
from .versions import Version, VersionStore

__all__ = [
    "EnginePoisoned",
    "OnlineEngine",
    "UpdateResult",
    "make_online",
    "online_names",
]

class EnginePoisoned(RuntimeError):
    """The engine fail-stopped after a mid-patch apply failure.

    Carries what recovery needs: ``cause`` is the original exception and
    ``seq`` the failing update's journal sequence number (``None`` when the
    engine runs unjournaled). Queries keep serving published versions; a
    successful checkpoint+journal restore (``fault.durable``) replaces the
    poisoned engine with a consistent one — the aborted seq is skipped on
    replay, so the restored state is the last published version.
    """

    def __init__(self, name: str, seq, cause: BaseException):
        at = f" applying journaled update seq {seq}" if seq is not None else ""
        super().__init__(
            f"online engine {name!r} is fail-stopped after an apply error{at}: "
            f"{cause!r}; restore from checkpoint+journal or rebuild (queries "
            f"still serve published versions)"
        )
        self.engine = name
        self.seq = seq
        self.cause = cause


class UpdateResult(NamedTuple):
    """What one applied update batch did."""

    version: int  # the published version id
    n: int  # logical array length after the batch
    patched: bool  # True = incremental patch; False = structural rebuild
    n_writes: int  # coalesced in-place writes
    n_appended: int  # appended elements
    seconds: float  # apply wall time (patch + publish material)
    touched_shards: int = 1  # structure shards owning >= 1 changed position
    # Host->device bytes this publish uploaded (the windowed-COW publish).
    publish_bytes: int = 0


def _on_host(s):
    """``s`` (a NamedTuple of tensors, possibly nested) with numpy leaves,
    for the mirrors' ``from_state``."""
    if isinstance(s, torch.Tensor):
        return to_numpy(s)
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        return type(s)(*(_on_host(v) for v in s))
    return s


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array; never shares memory with it (the
    mirrors are patched in place after a publish)."""
    return torch.from_numpy(np.ascontiguousarray(host)).to(device, copy=True)


# --- windowed copy-on-write publish ------------------------------------------
#
# A publish installs fresh device leaves for the next MVCC version. Instead of
# uploading every host mirror in full (~O(n log n) bytes for an O(log n)-window
# point patch), each leaf keeps its current device tensor and a publish clones
# it on the device and writes only the patched windows into the clone. The
# previous tensor belongs to a published version that pinned queries may
# still read, so it is never written: only the window bytes cross from the
# host. Window lengths are padded to powers of two (the padding uploads
# unchanged-but-correct mirror content), as in the reference, so
# ``publish_bytes`` counts the same bytes.


def _padded_span(a: int, b: int, m: int) -> Tuple[int, int]:
    """Inclusive [a, b] -> (start, pow2 length), shifted left to fit in m."""
    ln = b - a + 1
    p = 1 << (ln - 1).bit_length()
    if p >= m:
        return 0, m
    return min(a, m - p), p


class _CowLeaf:
    """One device-resident structure leaf published copy-on-write.

    ``full(host)`` re-uploads the mirror (shape changed); ``splice`` /
    ``splice_rows`` upload only the padded patch windows into a device-side
    clone of the previous tensor. Either way the uploaded byte count
    accumulates into the shared ``counter`` (an UpdateResult.publish_bytes
    source) and ``dev`` is the leaf for the next version.
    """

    __slots__ = ("dev", "_counter")

    def __init__(self, dev: torch.Tensor, counter):
        self.dev = dev
        self._counter = counter

    def full(self, host):
        self.dev = _upload(host, self.dev.device)
        self._counter["bytes"] += int(host.nbytes)
        return self.dev

    def _write(self, new: torch.Tensor, window: np.ndarray, where) -> None:
        new[where].copy_(torch.from_numpy(np.ascontiguousarray(window)))
        self._counter["bytes"] += int(window.nbytes)

    def splice(self, host, spans):
        """``spans``: (row, a, b) windows — row=None for a 1-D leaf."""
        if not spans:
            return self.dev
        m = int(host.shape[-1])
        new = self.dev.clone()
        for row, a, b in spans:
            s, p = _padded_span(a, b, m)
            if row is None:
                self._write(new, host[s : s + p], slice(s, s + p))
            else:
                self._write(new, host[row : row + 1, s : s + p], (slice(row, row + 1), slice(s, s + p)))
        self.dev = new
        return self.dev

    def splice_rows(self, host, runs):
        """``runs``: inclusive (a, b) row ranges of a 2-D leaf (full width)."""
        if not runs:
            return self.dev
        nrows = int(host.shape[0])
        new = self.dev.clone()
        for a, b in runs:
            s, p = _padded_span(a, b, nrows)
            self._write(new, host[s : s + p], slice(s, s + p))
        self.dev = new
        return self.dev


class _BlockLeaves:
    """The four device leaves of a ``BlockRMQ``, published copy-on-write."""

    def __init__(self, m: BlockMirror, counter, device, state: Optional[BlockRMQ] = None):
        if state is None:  # restore: seed from the mirror (no argmin rebuild)
            bv = _upload(m.bmin_val, device)
            state = BlockRMQ(
                x_blocks=_upload(m.x_blocks, device),
                bmin_val=bv,
                bmin_gidx=_upload(m.bmin_gidx, device),
                st=SparseTable(idx=_upload(m.st_idx, device), x=bv),
            )
        self.xb = _CowLeaf(state.x_blocks, counter)
        self.bv = _CowLeaf(state.bmin_val, counter)
        self.bg = _CowLeaf(state.bmin_gidx, counter)
        self.bst = _CowLeaf(state.st.idx, counter)

    def state(self) -> BlockRMQ:
        return BlockRMQ(
            x_blocks=self.xb.dev,
            bmin_val=self.bv.dev,
            bmin_gidx=self.bg.dev,
            st=SparseTable(idx=self.bst.dev, x=self.bv.dev),
        )

    def publish(self, m: BlockMirror) -> BlockRMQ:
        """Refresh the leaves from the just-patched mirror, windowed."""
        if m.last_block_runs is None:  # block count grew: shapes changed
            self.xb.full(m.x_blocks)
            self.bv.full(m.bmin_val)
            self.bg.full(m.bmin_gidx)
            self.bst.full(m.st_idx)
        else:
            runs1d = [(None, a, b) for a, b in m.last_block_runs]
            self.xb.splice_rows(m.x_blocks, m.last_block_runs)
            self.bv.splice(m.bmin_val, runs1d)
            self.bg.splice(m.bmin_gidx, runs1d)
            self.bst.splice(m.st_idx, m.last_st_windows)
        return self.state()


class _Impl(NamedTuple):
    """One engine's online hooks: the resolved plan, the initial state,
    ``patch(batch, prev_state) -> (next_state, was_incremental)``, plus
    ``snapshot() -> {name: np.ndarray}`` (the host-side structure leaves;
    a factory given ``snap=...`` reconstructs the same state without
    re-running the argmin build), ``array() -> np.ndarray`` (a host copy of
    the current logical array: published on every version for the degraded
    fallback and oracle checks) and ``publish_bytes() -> int``."""

    plan: build_mod.BuildPlan
    state0: object
    patch: Callable
    snapshot: Optional[Callable] = None
    array: Optional[Callable] = None
    publish_bytes: Optional[Callable] = None


# --- single-host implementations --------------------------------------------
#
# The host mirrors ARE the built structures, so a snapshot persists the
# mirror leaves and a restore re-seats them without recomputing an argmin.


def _sparse_table_impl(x, device, kw, snap=None) -> _Impl:
    plan = build_mod.plan_for("sparse_table", x.shape[0], device=device)
    pub = {"bytes": 0}
    if snap is None:
        state0 = build_mod.execute(plan, x)
        mirror = STMirror.from_state(_on_host(state0[0]))
        idx_leaf = _CowLeaf(state0[0].idx, pub)
        x_leaf = _CowLeaf(state0[1], pub)
    else:
        mirror = STMirror(snap["st_idx"], snap["x"])
        idx_leaf = _CowLeaf(_upload(mirror.idx, device), pub)
        x_leaf = _CowLeaf(_upload(mirror.x, device), pub)
        state0 = (SparseTable(idx=idx_leaf.dev, x=x_leaf.dev), x_leaf.dev)

    def patch(batch: DeltaBatch, prev):
        pub["bytes"] = 0
        mirror.patch(batch)
        if mirror.last_idx_windows is None:  # grew: leaf shapes changed
            xj = x_leaf.full(mirror.x)
            ij = idx_leaf.full(mirror.idx)
        else:
            xj = x_leaf.splice(mirror.x, [(None, a, b) for a, b in mirror.last_x_windows])
            ij = idx_leaf.splice(mirror.idx, mirror.last_idx_windows)
        return (SparseTable(idx=ij, x=xj), xj), True

    return _Impl(
        plan,
        state0,
        patch,
        snapshot=lambda: {"x": mirror.x.copy(), "st_idx": mirror.idx.copy()},
        array=lambda: mirror.x.copy(),
        publish_bytes=lambda: pub["bytes"],
    )


def _block_impl(block_size: int):
    def factory(x, device, kw, snap=None) -> _Impl:
        bs = kw.get("block_size", block_size)
        plan = build_mod.plan_for("block", x.shape[0], device=device, block_size=bs)
        pub = {"bytes": 0}
        if snap is None:
            state0 = build_mod.execute(plan, x)
            mirror = BlockMirror.from_state(_on_host(state0), x.shape[0])
            leaves = _BlockLeaves(mirror, pub, device, state=state0)
        else:
            mirror = BlockMirror(
                snap["x_blocks"], snap["bmin_val"], snap["bmin_gidx"], snap["st_idx"], snap["x"].shape[0]
            )
            leaves = _BlockLeaves(mirror, pub, device)
            state0 = leaves.state()

        def patch(batch: DeltaBatch, prev):
            pub["bytes"] = 0
            mirror.patch(batch)
            return leaves.publish(mirror), True

        return _Impl(
            plan,
            state0,
            patch,
            snapshot=lambda: {
                "x": mirror.x_blocks.reshape(-1)[: mirror.n].copy(),
                "x_blocks": mirror.x_blocks.copy(),
                "bmin_val": mirror.bmin_val.copy(),
                "bmin_gidx": mirror.bmin_gidx.copy(),
                "st_idx": mirror.st_idx.copy(),
            },
            array=lambda: mirror.x_blocks.reshape(-1)[: mirror.n].copy(),
            publish_bytes=lambda: pub["bytes"],
        )

    return factory


def _hybrid_impl(x, device, kw, snap=None) -> _Impl:
    if build_mod._norm_packed(kw.get("packed")) is not None:
        return _packed_hybrid_impl(x, device, kw, snap=snap)
    # The online hybrid pins the plain short path, as the reference does: the
    # fused kernels' structures (the dma tables) are not patched in place.
    plan = build_mod.plan_for(
        "hybrid",
        x.shape[0],
        device=device,
        block_size=kw.get("block_size", 128),
        threshold=kw.get("threshold"),
        use_kernels=False,
    )
    pub = {"bytes": 0}

    def _assemble(blocked: BlockRMQ, table: SparseTable, xj, threshold):
        return hybrid.assemble(blocked, table, xj, threshold, False)

    if snap is None:
        state0 = build_mod.execute(plan, x)
        blocked_m = BlockMirror.from_state(_on_host(state0.blocked), x.shape[0])
        st_m = STMirror.from_state(_on_host(state0.st))
        leaves = _BlockLeaves(blocked_m, pub, device, state=state0.blocked)
        ti_leaf = _CowLeaf(state0.st.idx, pub)
        x_leaf = _CowLeaf(state0.st.x, pub)
    else:
        blocked_m = BlockMirror(
            snap["b_x_blocks"], snap["b_bmin_val"], snap["b_bmin_gidx"], snap["b_st_idx"], snap["x"].shape[0]
        )
        st_m = STMirror(snap["st_idx"], snap["x"])
        leaves = _BlockLeaves(blocked_m, pub, device)
        ti_leaf = _CowLeaf(_upload(st_m.idx, device), pub)
        x_leaf = _CowLeaf(_upload(st_m.x, device), pub)
        # The snapshot was taken under the plan's resolved threshold (the
        # restore kwargs pin it), so routing is identical to the live engine.
        state0 = _assemble(
            leaves.state(), SparseTable(idx=ti_leaf.dev, x=x_leaf.dev), x_leaf.dev, plan.meta["threshold"]
        )

    def patch(batch: DeltaBatch, prev):
        pub["bytes"] = 0
        blocked_m.patch(batch)
        st_m.patch(batch)
        blocked = leaves.publish(blocked_m)
        if st_m.last_idx_windows is None:  # grew: full-array leaves changed shape
            xj = x_leaf.full(st_m.x)
            ti = ti_leaf.full(st_m.idx)
        else:
            xj = x_leaf.splice(st_m.x, [(None, a, b) for a, b in st_m.last_x_windows])
            ti = ti_leaf.splice(st_m.idx, st_m.last_idx_windows)
        return _assemble(blocked, SparseTable(idx=ti, x=xj), xj, prev.threshold), True

    return _Impl(
        plan,
        state0,
        patch,
        snapshot=lambda: {
            "x": st_m.x.copy(),
            "st_idx": st_m.idx.copy(),
            "b_x_blocks": blocked_m.x_blocks.copy(),
            "b_bmin_val": blocked_m.bmin_val.copy(),
            "b_bmin_gidx": blocked_m.bmin_gidx.copy(),
            "b_st_idx": blocked_m.st_idx.copy(),
        },
        array=lambda: st_m.x.copy(),
        publish_bytes=lambda: pub["bytes"],
    )


# --- packed single-host hybrid -----------------------------------------------


def _spec_blob(spec) -> np.ndarray:
    """The ``PackSpec`` as a uint8 JSON blob (snapshots persist arrays only).

    The concrete spec must survive a snapshot: an overflow-triggered rebuild
    re-biases the key range, after which ``spec_for`` over the restored array
    would derive a different (equally valid) spec.
    """
    return np.frombuffer(json.dumps(spec.to_meta()).encode(), np.uint8)


def _spec_from_blob(blob: np.ndarray):
    return packing.PackSpec.from_meta(json.loads(np.asarray(blob, np.uint8).tobytes()))


def _packed_hybrid_impl(x, device, kw, snap=None) -> _Impl:
    """Online packed hybrid: packed mirrors + windowed word-plane publish.

    The packed mirrors (``update.patch``) delegate the exact windowed repair
    to the raw mirrors and repack words over only the recomputed windows. A
    batch the build-time spec cannot encode (a packed32 value outside the
    key range, appends past the index field) raises ``OverflowError`` BEFORE
    any mirror mutates and falls back to a structural rebuild under a fresh
    spec; packed64 always fits, so its appends stay incremental.
    """
    layout_req = build_mod._norm_packed(kw.get("packed", "auto")) or "auto"
    plan = build_mod.plan_for(
        "hybrid",
        x.shape[0],
        device=device,
        block_size=kw.get("block_size", 128),
        threshold=kw.get("threshold"),
        use_kernels=False,
        packed=layout_req,
    )
    bs = plan.meta["block_size"]
    pub = {"bytes": 0}

    def _assemble(blocked, table, xj, threshold, spec):
        return hybrid.assemble(blocked, table, xj, threshold, False, spec=spec)

    def _seed(state, x_host):
        """Mirrors + COW leaves over a freshly built packed state."""
        spec = state.spec
        blocked_m = PackedBlockMirror.from_state(_on_host(state.blocked), spec, x_host.shape[0])
        st_m = PackedSTMirror.from_state(_on_host(state.st), x_host, spec)
        leaves = {
            "blocks": _CowLeaf(state.blocked.blocks, pub),
            "stw": _CowLeaf(state.blocked.stw, pub),
            "words": _CowLeaf(state.st.words, pub),
            "x": _CowLeaf(state.x, pub),
        }
        return spec, blocked_m, st_m, leaves

    if snap is None:
        state0 = build_mod.execute(plan, x)
        spec, blocked_m, st_m, leaves = _seed(state0, to_numpy(x))
    else:
        spec = _spec_from_blob(snap["spec"])
        blocked_m = PackedBlockMirror(snap["b_blocks"], snap["b_stw"], spec, snap["x"].shape[0])
        st_m = PackedSTMirror(snap["st_words"], snap["x"], spec)
        leaves = {
            k: _CowLeaf(_upload(snap[s], device), pub)
            for k, s in (("blocks", "b_blocks"), ("stw", "b_stw"), ("words", "st_words"), ("x", "x"))
        }
        state0 = _assemble(
            block_rmq.PackedBlockRMQ(blocks=leaves["blocks"].dev, stw=leaves["stw"].dev),
            sparse_table.PackedSparseTable(
                words=leaves["words"].dev, x=leaves["x"].dev if spec.layout == "quantized" else None
            ),
            leaves["x"].dev,
            plan.meta["threshold"],
            spec,
        )

    def patch(batch: DeltaBatch, prev):
        nonlocal spec, blocked_m, st_m, leaves
        pub["bytes"] = 0
        vals = np.concatenate([batch.val, batch.tail.astype(batch.val.dtype)])
        try:
            packed_fit_check(spec, vals, batch.n_new)
        except OverflowError:
            # The build-time spec cannot encode this batch: structural
            # rebuild under a fresh spec (threshold pinned, deterministic).
            xh = batch.apply_numpy(st_m.x)
            p2 = build_mod.plan_for(
                "hybrid",
                batch.n_new,
                device=device,
                block_size=bs,
                threshold=int(prev.threshold),
                use_kernels=False,
                packed=layout_req,
            )
            state = build_mod.execute(p2, torch.from_numpy(xh))
            spec, blocked_m, st_m, leaves = _seed(state, xh)
            return state, False
        blocked_m.patch(batch)
        st_m.patch(batch)
        b_host = (
            blocked_m.block_words
            if blocked_m.block_words is not None  # quantized keeps raw blocks
            else blocked_m.inner.x_blocks
        )
        if blocked_m.last_block_runs is None:  # block count grew
            bw = leaves["blocks"].full(b_host)
            sw = leaves["stw"].full(blocked_m.stw_words)
        else:
            bw = leaves["blocks"].splice_rows(b_host, blocked_m.last_block_runs)
            sw = leaves["stw"].splice(blocked_m.stw_words, blocked_m.last_st_windows)
        if st_m.last_word_windows is None:  # grew: full-plane shapes changed
            wj = leaves["words"].full(st_m.words)
            xj = leaves["x"].full(st_m.x)
        else:
            wj = leaves["words"].splice(st_m.words, st_m.last_word_windows)
            xj = leaves["x"].splice(st_m.x, [(None, a, b) for a, b in st_m.last_x_windows])
        blocked = block_rmq.PackedBlockRMQ(blocks=bw, stw=sw)
        table = sparse_table.PackedSparseTable(words=wj, x=xj if spec.layout == "quantized" else None)
        return _assemble(blocked, table, xj, prev.threshold, spec), True

    def snapshot():
        b_host = blocked_m.block_words if blocked_m.block_words is not None else blocked_m.inner.x_blocks
        return {
            "x": st_m.x.copy(),
            "st_words": st_m.words.copy(),
            "b_blocks": b_host.copy(),
            "b_stw": blocked_m.stw_words.copy(),
            "spec": _spec_blob(spec),
        }

    return _Impl(
        plan,
        state0,
        patch,
        snapshot=snapshot,
        array=lambda: st_m.x.copy(),
        publish_bytes=lambda: pub["bytes"],
    )


# --- mesh implementations ----------------------------------------------------
#
# Mesh-resident structures: the snapshot is the logical array only, and a
# restore re-runs the BuildPlan over it (the restore kwargs pin the
# threshold, mode and layout), equal to the live patched state by the
# patched == rebuilt invariant. ``where`` holds the plan's placement:
# ``mesh``/``axis_names`` (or ``device`` for the default mesh).


def _mesh_vals(batch: DeltaBatch) -> np.ndarray:
    """The values at ``batch.touched()``: the writes, then the tail."""
    return np.concatenate([batch.val, batch.tail.astype(batch.val.dtype)])


def _replicated(tree, mesh):
    """Host leaves of a mirror-built structure, one fresh copy per device of
    ``mesh`` (never sharing memory with the mirrors, which are patched in
    place after a publish: an upload to a card copies, and on the CPU
    ``copy=True`` does)."""
    (devs,) = distributed.shard_devices(mesh, ())
    return distributed._map(
        lambda a: distributed.ShardedLeaf([{d: torch.from_numpy(a).to(d, copy=True) for d in devs}]), tree
    )


def _distributed_impl(x, where, kw, snap=None) -> _Impl:
    plan = build_mod.plan_for("distributed", x.shape[0], **where, block_size=kw.get("block_size", 128))
    state0 = build_mod.execute(plan, x)
    mesh, axes = plan.meta["mesh"], plan.meta["axis_names"]
    bs = plan.meta["block_size"]
    x_host = to_numpy(x)  # full-array mirror: the rebuild source

    def patch(batch: DeltaBatch, prev):
        nonlocal x_host
        x_host = batch.apply_numpy(x_host)
        s, qfn = prev
        nb, bsz = s.x_blocks.shape
        if batch.n_new > nb * bsz:  # grew past the padded shard capacity
            p2 = build_mod.plan_for("distributed", batch.n_new, mesh=mesh, axis_names=axes, block_size=bs)
            return build_mod.execute(p2, torch.from_numpy(x_host)), False
        return (distributed.patch_sharded(s, batch.touched(), _mesh_vals(batch), mesh, axes), qfn), True

    return _Impl(plan, state0, patch, snapshot=lambda: {"x": x_host.copy()}, array=lambda: x_host.copy())


def _sharded_hybrid_impl(x, where, kw, snap=None) -> _Impl:
    if build_mod._norm_packed(kw.get("packed")) is not None:
        return _packed_sharded_hybrid_impl(x, where, kw, snap=snap)
    plan = build_mod.plan_for(
        "sharded_hybrid",
        x.shape[0],
        **where,
        block_size=kw.get("block_size", 128),
        threshold=kw.get("threshold"),
        mode=kw.get("mode", "shard_structure"),
    )
    state0 = build_mod.execute(plan, x)
    mesh, struct_axes = plan.meta["mesh"], plan.meta["struct_axes"]
    mode, bs = plan.meta["mode"], plan.meta["block_size"]
    x_host = to_numpy(x)
    snapshot = lambda: {"x": x_host.copy()}
    array = lambda: x_host.copy()

    if not struct_axes:  # shard_batch: replicated structures, host mirrors
        blocked_m = BlockMirror.from_state(state0.blocked, x.shape[0])
        st_m = STMirror.from_state(state0.st)

        def patch(batch: DeltaBatch, prev):
            nonlocal x_host
            x_host = batch.apply_numpy(x_host)
            blocked_m.patch(batch)
            st_m.patch(batch)
            blocked = _replicated(
                BlockRMQ(blocked_m.x_blocks, blocked_m.bmin_val, blocked_m.bmin_gidx, SparseTable(blocked_m.st_idx, None)),
                mesh,
            )
            blocked = blocked._replace(st=blocked.st._replace(x=blocked.bmin_val))
            table = _replicated(SparseTable(st_m.idx, st_m.x), mesh)
            return prev._replace(blocked=blocked, st=table, n=batch.n_new), True

        return _Impl(plan, state0, patch, snapshot=snapshot, array=array)

    def patch(batch: DeltaBatch, prev):
        nonlocal x_host
        x_host = batch.apply_numpy(x_host)
        nb, bsz = prev.blocked.x_blocks.shape
        if batch.n_new > min(nb * bsz, prev.st.idx.shape[1]):
            # Structural rebuild (capacity exceeded); the routing threshold
            # stays pinned so the rebuild is as deterministic as the patch.
            p2 = build_mod.plan_for(
                "sharded_hybrid",
                batch.n_new,
                mesh=mesh,
                axis_names=plan.meta["axis_names"],
                block_size=bs,
                threshold=int(prev.threshold),
                mode=mode,
            )
            return build_mod.execute(p2, torch.from_numpy(x_host)), False
        pos, vals = batch.touched(), _mesh_vals(batch)
        return (
            prev._replace(
                blocked=distributed.patch_sharded(prev.blocked, pos, vals, mesh, struct_axes),
                st=distributed.patch_sharded_st(prev.st, pos, vals, mesh, struct_axes),
                n=batch.n_new,
            ),
            True,
        )

    return _Impl(plan, state0, patch, snapshot=snapshot, array=array)


def _packed_sharded_hybrid_impl(x, where, kw, snap=None) -> _Impl:
    """Online packed sharded hybrid: single-plane patches.

    Structure-sharded modes patch through ``distributed.patch_sharded_packed``
    / ``patch_sharded_st_packed`` (one word plane rides the halo transport);
    ``shard_batch`` patches host packed mirrors and re-replicates. A batch
    the spec cannot encode (packed32 key range, appends past the index
    field) raises ``OverflowError`` on the host before any device write and
    rebuilds under a fresh spec.
    """
    layout_req = build_mod._norm_packed(kw.get("packed", "auto")) or "auto"
    plan = build_mod.plan_for(
        "sharded_hybrid",
        x.shape[0],
        **where,
        block_size=kw.get("block_size", 128),
        threshold=kw.get("threshold"),
        mode=kw.get("mode", "shard_structure"),
        packed=layout_req,
    )
    state0 = build_mod.execute(plan, x)
    mesh, struct_axes = plan.meta["mesh"], plan.meta["struct_axes"]
    mode, bs = plan.meta["mode"], plan.meta["block_size"]
    x_host = to_numpy(x)
    spec = state0.spec
    snapshot = lambda: {"x": x_host.copy()}
    array = lambda: x_host.copy()

    def _rebuild(n_new, threshold):
        nonlocal spec
        p2 = build_mod.plan_for(
            "sharded_hybrid",
            n_new,
            mesh=mesh,
            axis_names=plan.meta["axis_names"],
            block_size=bs,
            threshold=threshold,
            mode=mode,
            packed=layout_req,
        )
        state = build_mod.execute(p2, torch.from_numpy(x_host))
        spec = state.spec
        return state

    if not struct_axes:  # shard_batch: replicated structures, packed mirrors
        blocked_m = PackedBlockMirror.from_state(state0.blocked, spec, x.shape[0])
        st_m = PackedSTMirror.from_state(state0.st, x_host, spec)

        def patch(batch: DeltaBatch, prev):
            nonlocal x_host, blocked_m, st_m
            try:
                packed_fit_check(spec, _mesh_vals(batch), batch.n_new)
            except OverflowError:
                x_host = batch.apply_numpy(x_host)
                state = _rebuild(batch.n_new, int(prev.threshold))
                blocked_m = PackedBlockMirror.from_state(state.blocked, spec, batch.n_new)
                st_m = PackedSTMirror.from_state(state.st, x_host, spec)
                return state, False
            x_host = batch.apply_numpy(x_host)
            blocked_m.patch(batch)
            st_m.patch(batch)
            # Mesh packing is never quantized, so both word planes exist.
            blocked = _replicated(block_rmq.PackedBlockRMQ(blocked_m.block_words, blocked_m.stw_words), mesh)
            table = _replicated(sparse_table.PackedSparseTable(words=st_m.words), mesh)
            return prev._replace(blocked=blocked, st=table, n=batch.n_new), True

        return _Impl(plan, state0, patch, snapshot=snapshot, array=array)

    def patch(batch: DeltaBatch, prev):
        nonlocal x_host
        vals = _mesh_vals(batch)
        x_host = batch.apply_numpy(x_host)
        nb, bsz = prev.blocked.blocks.shape
        if batch.n_new > min(nb * bsz, prev.st.words.shape[1]):
            return _rebuild(batch.n_new, int(prev.threshold)), False
        try:
            # Appends inside the padded capacity can still outgrow the
            # spec's index field: checked on the host before any scatter.
            packed_fit_check(spec, vals, batch.n_new)
        except OverflowError:
            return _rebuild(batch.n_new, int(prev.threshold)), False
        pos = batch.touched()
        return (
            prev._replace(
                blocked=distributed.patch_sharded_packed(prev.blocked, pos, vals, mesh, struct_axes, spec),
                st=distributed.patch_sharded_st_packed(prev.st, pos, vals, mesh, struct_axes, spec),
                n=batch.n_new,
            ),
            True,
        )

    return _Impl(plan, state0, patch, snapshot=snapshot, array=array)


_FACTORIES: Dict[str, Callable] = {
    "sparse_table": _sparse_table_impl,
    "block128": _block_impl(128),
    "block256": _block_impl(256),
    "hybrid": _hybrid_impl,
    "distributed": _distributed_impl,
    "sharded_hybrid": _sharded_hybrid_impl,
    "packed_hybrid": _packed_hybrid_impl,
    "packed_sharded_hybrid": _packed_sharded_hybrid_impl,
}


def online_names() -> Tuple[str, ...]:
    """Engines with an online patch implementation (= registry ``updatable``)."""
    return tuple(sorted(_FACTORIES))


class OnlineEngine:
    """One updatable engine under MVCC: pinned-version queries + delta apply.

    ``apply`` lowers through the ``apply_deltas`` -> ``publish`` stages of
    ``core.build.update_plan`` (observable like any BuildPlan); queries go
    through ``pin()``/``release()`` so in-flight work keeps its snapshot
    while updates publish. Thread-safe: ``apply`` is serialized, pins are
    refcounted. The structures live on ``device`` (``None``: CUDA); a mesh
    engine's live on ``mesh`` (over ``axis_names``; without a mesh, the
    default mesh of ``device``), and a mesh takes the place of ``device``.
    """

    def __init__(
        self,
        name: str,
        x,
        *,
        device=None,
        mesh=None,
        axis_names=None,
        _snapshot=None,  # snapshot leaves: restore path (see from_snapshot)
        _first_vid: int = 0,  # version-id continuity across a restore
        **build_kw,
    ):
        spec = registry.get(name)
        if not spec.updatable:
            raise ValueError(f"engine {name!r} is not updatable; have {registry.updatable_names()}")
        if mesh is not None and device is not None:
            raise ValueError("pass mesh= or device=, not both: a mesh names its own devices")
        if mesh is not None or axis_names is not None:
            if not spec.needs_mesh:
                raise ValueError(f"engine {name!r} builds on one device: pass device=, not a mesh")
            if mesh is None:
                raise ValueError("axis_names= needs a mesh")
        if mesh is not None:
            self.device = distributed.home_device(mesh)
        else:
            self.device = resolve(device)
        x = torch.as_tensor(to_numpy(x)).to(self.device)
        if x.ndim != 1:
            raise ValueError(f"need a 1-D array, got shape {tuple(x.shape)}")
        self.name = name
        self.spec = spec
        if spec.needs_mesh:
            where = {"mesh": mesh, "axis_names": axis_names} if mesh is not None else {"device": self.device}
            impl = _FACTORIES[name](x, where, build_kw, snap=_snapshot)
            # The mesh the plan resolved (the default one when none was given).
            self.mesh, self.axis_names = impl.plan.meta["mesh"], impl.plan.meta["axis_names"]
            self._devices = self.mesh.physical_devices
        else:
            impl = _FACTORIES[name](x, self.device, build_kw, snap=_snapshot)
            self.mesh = self.axis_names = None
            self._devices = (self.device,)
        self.plan = impl.plan
        self._dtype = np.dtype(to_numpy(x[:0]).dtype)
        # Pin the plan-resolved knobs: a snapshot restored with these kwargs
        # re-plans to the exact same layout/threshold/mode deterministically.
        self._build_kw = dict(build_kw)
        for key in ("block_size", "threshold", "mode", "packed"):
            val = self.plan.meta.get(key)
            if val is not None:
                self._build_kw[key] = int(val) if isinstance(val, (int, np.integer)) else val
        self.store = VersionStore(first_vid=_first_vid)
        self._apply_lock = threading.Lock()
        self._failed: Optional[BaseException] = None
        self._failed_seq: Optional[int] = None
        self._sync()
        self.store.publish(impl.state0, x.shape[0], x_host=impl.array())
        # The store owns version 0 now; keeping state0 on the impl would pin
        # its tensors for the engine's whole lifetime.
        self._impl = impl._replace(state0=None)
        self._uplan = build_mod.update_plan(
            name, self.plan.layout, self._stage_apply, self._stage_publish, meta=self.plan.meta
        )

    # -- versions -------------------------------------------------------------

    @property
    def n(self) -> int:
        return self.store.current.n

    @property
    def current_vid(self) -> int:
        return self.store.current_vid

    @property
    def dtype(self) -> np.dtype:
        """Value dtype (what ``DeltaLog.coalesce`` must target)."""
        return self._dtype

    @property
    def poisoned(self) -> bool:
        """True once a mid-patch failure fail-stopped the applier."""
        return self._failed is not None

    def pin(self) -> Version:
        return self.store.pin()

    def release(self, vid: int) -> None:
        self.store.release(vid)

    def query(self, state, l, r):
        """The registry conformance query against one pinned version's state."""
        return self.spec.query(state, l, r)

    # -- snapshots ------------------------------------------------------------

    def snapshot(self):
        """``(arrays, meta)`` capturing the current version: host copies of
        the structure leaves and the JSON-serializable identity (engine, vid,
        n, dtype and the plan-resolved build kwargs). The reference's
        ``OnlineEngine.snapshot`` gives the same keys, so either package
        resumes the other's (``convert.online_engine``). Taken under the
        apply lock; refuses on a poisoned engine."""
        with self._apply_lock:
            if self._failed is not None:
                raise EnginePoisoned(self.name, self._failed_seq, self._failed)
            arrays = dict(self._impl.snapshot())
            meta = {
                "engine": self.name,
                "vid": int(self.store.current_vid),
                "n": int(self.n),
                "dtype": str(self._dtype),
                "build_kw": dict(self._build_kw),
            }
            return arrays, meta

    @classmethod
    def from_snapshot(cls, arrays, meta, *, device=None, mesh=None, axis_names=None):
        """Reconstruct an engine from ``snapshot()`` output on ``device``
        (a mesh engine: on ``mesh``, which the caller supplies, as meshes are
        not serialized).

        Version ids continue from the snapshot's vid (the restored initial
        publish IS that version).
        """
        x = np.ascontiguousarray(arrays["x"])
        return cls(
            meta["engine"],
            x,
            device=device,
            mesh=mesh,
            axis_names=axis_names,
            _snapshot=arrays,
            _first_vid=int(meta["vid"]),
            **meta.get("build_kw", {}),
        )

    # -- mutation -------------------------------------------------------------

    def _sync(self) -> None:
        """Wait for this thread's device work (the clones, the window
        uploads and the shard patches) on every device the engine's tensors
        live on: a version is published only once its tensors are complete,
        whatever stream a later query runs on."""
        for dev in self._devices:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def _stage_apply(self, state: dict) -> dict:
        batch: DeltaBatch = state["deltas"]
        new_state, patched = self._impl.patch(batch, self.store.current.state)
        self._sync()
        state["patched"] = new_state
        state["incremental"] = patched
        return state

    def _stage_publish(self, state: dict) -> dict:
        batch: DeltaBatch = state["deltas"]
        vid = self.store.publish(state.pop("patched"), batch.n_new, x_host=self._impl.array())
        layout = self.plan.layout
        state["result"] = UpdateResult(
            version=vid,
            n=batch.n_new,
            patched=state["incremental"],
            n_writes=int(batch.idx.size),
            n_appended=int(batch.tail.size),
            seconds=0.0,
            touched_shards=(
                len(shard_batches(batch, layout.num_shards, layout.shard_len))
                if layout.num_shards > 1
                else 1
            ),
            publish_bytes=int(self._impl.publish_bytes()) if self._impl.publish_bytes is not None else 0,
        )
        return state

    def _check_batch(self, batch: DeltaBatch) -> None:
        """Reject malformed batches BEFORE any mirror mutation: patching is
        in-place on shared host mirrors, so a mid-patch failure cannot be
        rolled back (it fail-stops the engine instead — see ``apply``)."""
        if batch.n_old != self.n:
            raise ValueError(
                f"update batch coalesced for n={batch.n_old}, engine is at "
                f"n={self.n} (coalesce against the current length)"
            )
        if batch.idx.size:
            if batch.idx.min() < 0 or batch.idx.max() >= batch.n_old:
                raise ValueError(
                    f"write positions [{batch.idx.min()}, {batch.idx.max()}] outside [0, {batch.n_old})"
                )
            if batch.idx.size != batch.val.size:
                raise ValueError("idx/val length mismatch")
        if batch.n_new != batch.n_old + batch.tail.size:
            raise ValueError(f"inconsistent batch lengths: {batch}")

    def apply(
        self,
        deltas,
        *,
        observer: Optional[Callable] = None,
        seq: Optional[int] = None,
    ) -> UpdateResult:
        """Apply one update batch; returns the published ``UpdateResult``.

        ``deltas`` is a ``DeltaLog`` (coalesced here against the current
        length) or an already-coalesced ``DeltaBatch`` (validated before any
        mutation). Serialized: updates publish in apply order; queries
        against pinned versions proceed concurrently throughout. ``seq`` is
        the batch's journal sequence number when the caller journals
        (``fault.durable``) — recorded on failure so the poison error names
        the exact lost update.

        Failure semantics are **fail-stop**: malformed batches are rejected
        up front with the engine untouched, but an exception raised mid-patch
        may leave the host mirrors inconsistent with the published chain, so
        the engine marks itself failed and every later ``apply`` raises
        ``EnginePoisoned`` (carrying the original exception and failing
        seq). Queries keep serving the already-published versions; a
        journal-replay restore yields a clean replacement engine.
        """
        with self._apply_lock:
            if self._failed is not None:
                raise EnginePoisoned(self.name, self._failed_seq, self._failed) from self._failed
            tr = obs_trace.get_tracer()
            if isinstance(deltas, DeltaLog):
                with tr.span("coalesce", attrs={"engine": self.name} if tr.enabled else None):
                    batch = deltas.coalesce(self.n, dtype=self._dtype)
                    if tr.enabled:
                        obs_trace.set_attr("n_writes", int(batch.idx.size))
                        obs_trace.set_attr("n_appended", int(batch.tail.size))
            else:
                batch = deltas
            self._check_batch(batch)
            t0 = time.perf_counter()
            try:
                res = build_mod.execute_update(self._uplan, batch, observer=observer)
            except BaseException as e:
                self._failed = e
                self._failed_seq = seq
                raise
            return res._replace(seconds=time.perf_counter() - t0)


def make_online(name: str, x, *, device=None, mesh=None, axis_names=None, **build_kw) -> OnlineEngine:
    """Build engine ``name`` as an ``OnlineEngine`` over ``x`` on ``device``
    (a mesh engine: on ``mesh``)."""
    return OnlineEngine(name, x, device=device, mesh=mesh, axis_names=axis_names, **build_kw)
