"""Incremental recompute kernels: windowed structure patching on host mirrors.

The single-host engines keep a numpy **mirror** of their built structures
(materialized once from the device build, so the starting point is exactly
the built state). A coalesced ``DeltaBatch`` patches the mirror in place —
O(bs) block-min repair per touched block plus per-level doubling-table
recompute over only the affected column windows — and the engine publishes
the patched leaves as the next copy-on-write version.

Why host-side numpy: the structures contain **no arithmetic**, only
comparisons and leftmost argmins, so numpy patching is trivially
bit-identical to the jnp build (same IEEE comparisons, same leftmost-tie
argmin) — asserted leaf-for-leaf by tests/test_update.py. (NaN payloads are
out of scope, as everywhere else in the repo.)

A copy of ``repro/update/patch.py`` with ``packing`` taken from the port
(``repro_torch.core.packing``, whose numpy twins are the reference's): the
"jnp build" below is the port's torch build, which equals it leaf for leaf.
``level_windows`` is vectorized (the reference loops over every touched
position in Python, minutes for a fill of millions of values).

Window math (the reason patching is cheap): a doubling-table entry
``idx[k, c]`` covers ``[c, c + 2^k)`` (reads clamped at the array end stay
inside it), so a write at position ``p`` can only change level-``k`` entries
with ``c in [p - 2^k + 1, p]``. Patching recomputes exactly those merged
windows per level, top-down from the patched level below — everything
outside is untouched and therefore already equal to a from-scratch rebuild.
A single point write costs ``sum_k min(2^k, n) ~ 2n`` entries against the
rebuild's ``n log n``. Appends extend the windows with the appended suffix
``[n_old, n_new)`` (which also re-resolves the old tail-clamped entries) and
grow new levels in full when ``n`` crosses a power of two.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import packing

from .deltas import DeltaBatch

__all__ = [
    "BlockMirror",
    "PackedBlockMirror",
    "PackedSTMirror",
    "STMirror",
    "k_levels",
    "level_windows",
    "np_maxval",
    "packed_fit_check",
    "patch_doubling",
]


def np_maxval(dtype):
    """Numpy twin of ``block_rmq.maxval`` (pad identity for min)."""
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.floating):
        return dtype.type(np.inf)
    return np.iinfo(dtype).max


def k_levels(m: int) -> int:
    """Doubling-table depth for length ``m`` (matches ``sparse_table.build``)."""
    return max(1, (m - 1).bit_length() + 1) if m > 1 else 1


def level_windows(touched: np.ndarray, w: int, m: int) -> List[Tuple[int, int]]:
    """Merged inclusive windows ``[p - w, p]`` over sorted positions, clipped.

    The affected-column ranges for one table level: windows of adjacent
    touched positions merge, so scattered points stay scattered (two distant
    writes patch two small windows, not their hull). Vectorized: a window
    starts a new run where it begins past the previous position + 1 (the
    positions are sorted, so each run ends at its last position); equal to
    the reference's loop, in numpy time for a fill of millions of values.
    """
    p = np.minimum(np.asarray(touched, np.int64), m - 1)  # clamped reads: the last column covers the overhang
    if p.size == 0:
        return []
    a = np.maximum(p - w, 0)
    starts = np.flatnonzero(np.concatenate([[True], a[1:] > p[:-1] + 1]))
    ends = np.concatenate([starts[1:] - 1, [p.size - 1]])
    return list(zip(a[starts].tolist(), p[ends].tolist()))


def patch_doubling(
    idx: np.ndarray,
    values: np.ndarray,
    touched: np.ndarray,
    m_old: int,
    windows: Optional[List[Tuple[int, int, int]]] = None,
) -> np.ndarray:
    """Windowed per-level repair of a doubling table's index rows.

    ``idx`` is the (K_old, m_old) table over the OLD values; ``values`` is
    the already-mutated (m_new,) value array; ``touched`` lists the sorted
    positions whose value changed (appends contribute ``[m_old, m_new)``).
    Returns the patched (K_new, m_new) table — the same array patched in
    place when the length is unchanged, a grown copy otherwise. Bit-identical
    to ``sparse_table.build(values)``'s ``idx``.

    ``windows`` (optional out-param) collects every recomputed cell range as
    ``(k, a, b)`` inclusive column windows — the windowed-COW publish
    (``update.engines``) uploads exactly these to the device instead of the
    whole table. Rows that repeat the level below (``h >= m_new``) report
    the sub-window where the level below changed.
    """
    m_new = int(values.shape[0])
    k_old = idx.shape[0]
    k_new = k_levels(m_new)
    if m_new != m_old or k_new != k_old:
        grown = np.empty((k_new, m_new), np.int32)
        grown[:k_old, :m_old] = idx
        grown[0, m_old:] = np.arange(m_old, m_new, dtype=np.int32)
        idx = grown
    touched = np.asarray(touched, np.int64)
    if touched.size == 0:
        return idx
    for k in range(1, k_new):
        h = 1 << (k - 1)
        if h >= m_new:  # window spans the whole array: rows repeat
            idx[k] = idx[k - 1]
            if windows is not None:
                # The repeated row differs from its old self only where the
                # level below changed: entries at c > max(touched) cover no
                # touched position, so [0, clamp(max touched)] suffices.
                windows.append((k, 0, min(int(touched[-1]), m_new - 1)))
            continue
        # New levels (n crossed a power of two) have no old row: full window.
        wins = (
            [(0, m_new - 1)]
            if k >= k_old
            else level_windows(touched, (1 << k) - 1, m_new)
        )
        if windows is not None:
            windows.extend((k, a, b) for a, b in wins)
        prev = idx[k - 1]
        for a, b in wins:
            c = np.arange(a, b + 1, dtype=np.int64)
            j = np.minimum(c + h, m_new - 1)  # build's tail clamp (cur[-1])
            left = prev[a : b + 1]
            right = prev[j]
            # Leftmost-tie merge: prefer the unshifted (left) operand.
            idx[k, a : b + 1] = np.where(values[left] <= values[right], left, right)
    return idx


class STMirror:
    """Host mirror of a raw-array ``SparseTable`` (idx rows + values).

    After each ``patch``, ``last_idx_windows`` / ``last_x_windows`` describe
    which device cells a windowed-COW publish must refresh: per-level
    ``(k, a, b)`` table windows and merged ``(a, b)`` value windows. ``None``
    means the leaf shapes changed (the array grew) and the publish must
    re-upload in full.
    """

    def __init__(self, idx: np.ndarray, x: np.ndarray):
        self.idx = np.array(idx, np.int32)  # writable copy
        self.x = np.array(x)
        self.last_idx_windows: Optional[List[Tuple[int, int, int]]] = None
        self.last_x_windows: Optional[List[Tuple[int, int]]] = None

    @classmethod
    def from_state(cls, table) -> "STMirror":
        return cls(np.asarray(table.idx), np.asarray(table.x))

    def patch(self, batch: DeltaBatch) -> None:
        if batch.n_old != self.x.shape[0]:
            raise ValueError(
                f"batch for n={batch.n_old} on mirror of n={self.x.shape[0]}"
            )
        if batch.tail.size:
            self.x = np.concatenate([self.x, batch.tail.astype(self.x.dtype)])
        self.x[batch.idx] = batch.val.astype(self.x.dtype)
        grew = batch.tail.size > 0
        wins: List[Tuple[int, int, int]] = []
        self.idx = patch_doubling(
            self.idx, self.x, batch.touched(), batch.n_old, windows=wins
        )
        self.last_idx_windows = None if grew else wins
        self.last_x_windows = (
            None if grew else level_windows(batch.idx, 0, self.x.shape[0])
        )


class BlockMirror:
    """Host mirror of a ``BlockRMQ``: padded blocks, block minima, level-2 table.

    ``patch`` is the O(bs)-per-touched-block repair: scatter the new values,
    re-argmin only the touched blocks, then window-patch the doubling table
    over the block-min array (whose "positions" are block ids).
    """

    def __init__(self, x_blocks, bmin_val, bmin_gidx, st_idx, n: int):
        self.x_blocks = np.array(x_blocks)
        self.bmin_val = np.array(bmin_val)
        self.bmin_gidx = np.array(bmin_gidx, np.int32)
        self.st_idx = np.array(st_idx, np.int32)
        self.n = int(n)  # logical (pre-padding) length
        # Windowed-COW publish hints (see STMirror): merged runs of touched
        # block rows + the block-level table's (k, a, b) windows; None when
        # the block count grew (full re-upload). Appends *within* the padded
        # capacity keep every leaf shape, so they stay windowed.
        self.last_block_runs: Optional[List[Tuple[int, int]]] = None
        self.last_st_windows: Optional[List[Tuple[int, int, int]]] = None

    @property
    def block_size(self) -> int:
        return self.x_blocks.shape[1]

    @classmethod
    def from_state(cls, s, n: int) -> "BlockMirror":
        return cls(
            np.asarray(s.x_blocks),
            np.asarray(s.bmin_val),
            np.asarray(s.bmin_gidx),
            np.asarray(s.st.idx),
            n,
        )

    def patch(self, batch: DeltaBatch) -> None:
        if batch.n_old != self.n:
            raise ValueError(f"batch for n={batch.n_old} on mirror of n={self.n}")
        bs = self.block_size
        nb_old = self.x_blocks.shape[0]
        nb_new = -(-max(batch.n_new, 1) // bs)
        if nb_new > nb_old:  # appends grew past the padded capacity: new blocks
            big = np_maxval(self.x_blocks.dtype)
            dt = self.x_blocks.dtype
            self.x_blocks = np.concatenate(
                [self.x_blocks, np.full((nb_new - nb_old, bs), big, dt)]
            )
            self.bmin_val = np.concatenate(
                [self.bmin_val, np.full(nb_new - nb_old, big, dt)]
            )
            self.bmin_gidx = np.concatenate(
                [self.bmin_gidx, np.zeros(nb_new - nb_old, np.int32)]
            )
        pos = batch.touched()
        vals = np.concatenate([batch.val, batch.tail]).astype(self.x_blocks.dtype)
        self.x_blocks.reshape(-1)[pos] = vals
        # O(bs) block-min repair, vectorized over the touched blocks only.
        tb = np.unique(pos // bs)
        rows = self.x_blocks[tb]
        lidx = np.argmin(rows, axis=1).astype(np.int32)  # leftmost, as jnp
        self.bmin_val[tb] = rows[np.arange(tb.size), lidx]
        self.bmin_gidx[tb] = (tb * bs).astype(np.int32) + lidx
        wins: List[Tuple[int, int, int]] = []
        self.st_idx = patch_doubling(self.st_idx, self.bmin_val, tb, nb_old, windows=wins)
        grew = nb_new > nb_old
        self.last_block_runs = None if grew else level_windows(tb, 0, nb_new)
        self.last_st_windows = None if grew else wins
        self.n = batch.n_new


# --- packed mirrors ----------------------------------------------------------
#
# The packed structures' index fields are exact in every layout, so the
# packed mirrors delegate the windowed repair to the raw mirrors above and
# then REPACK words over exactly the recomputed windows. Bit-identity with a
# from-scratch ``build_packed`` follows from the order isomorphism: the
# word-min doubling picks the same leftmost argmin the exact index doubling
# does, so ``pack(x[idx[k, c]], idx[k, c])`` IS the word the build computes.


def packed_fit_check(spec, values: np.ndarray, n_new: int) -> None:
    """Raise ``OverflowError`` when a delta batch cannot encode under ``spec``.

    Called BEFORE any mirror mutation, so an infeasible batch (a packed32
    value outside the build-time key range, or an append pushing the index
    domain past ``idx_bits``) leaves the mirrors untouched and the caller
    falls back to a structural rebuild with a fresh spec. packed64 always
    fits (32-bit key + 32-bit index); quantized values clamp to the edge
    buckets (weakly monotone, resolved by the exact fallback) so only its
    index domain can overflow.
    """
    if spec.layout != "packed64" and packing.idx_bits_for(max(n_new, 1)) > spec.idx_bits:
        raise OverflowError(
            f"appends grew the index domain to {n_new}, past the "
            f"{spec.idx_bits}-bit index field"
        )
    if spec.layout == "packed32" and values.size:
        packing.pack_np(
            spec,
            np.asarray(values, np.dtype(spec.dtype)),
            np.zeros(values.size, np.int32),
        )


class PackedSTMirror:
    """Host mirror of a ``PackedSparseTable``: exact raw mirror + word plane.

    Wraps an ``STMirror`` (the exact index/value repair, with its window
    collection) and repacks ``words`` over only the recomputed cells.
    ``last_word_windows`` lists the repacked ``(k, a, b)`` windows for the
    windowed-COW publish (``None`` -> shapes changed, full re-upload);
    ``last_x_windows`` mirrors the raw value windows for the quantized
    layout's retained ``x`` leaf.
    """

    def __init__(self, words: np.ndarray, x: np.ndarray, spec):
        self.spec = spec
        self.words = np.array(words)
        self.inner = STMirror(packing.unpack_idx_np(spec, np.asarray(words)), x)
        self.last_word_windows: Optional[List[Tuple[int, int, int]]] = None
        self.last_x_windows: Optional[List[Tuple[int, int]]] = None

    @property
    def x(self) -> np.ndarray:
        return self.inner.x

    @classmethod
    def from_state(cls, table, x, spec) -> "PackedSTMirror":
        """``table`` is the built ``PackedSparseTable``; ``x`` the raw host
        values (the quantized table retains them; exact layouts pass the
        engine's value mirror)."""
        return cls(np.asarray(table.words), np.array(x), spec)

    def _repack(self, k: int, a: int, b: int) -> None:
        ii = self.inner.idx[k, a : b + 1]
        self.words[k, a : b + 1] = packing.pack_np(self.spec, self.inner.x[ii], ii)

    def patch(self, batch: DeltaBatch) -> None:
        self.inner.patch(batch)
        if self.inner.last_idx_windows is None:  # grew: shapes changed
            idx = self.inner.idx
            self.words = packing.pack_np(self.spec, self.inner.x[idx], idx)
            self.last_word_windows = None
            self.last_x_windows = None
            return
        # Level 0 is the packed value row itself: every changed value
        # re-encodes, even where the (identity) index row did not move.
        wins = [(0, a, b) for a, b in self.inner.last_x_windows]
        wins.extend(self.inner.last_idx_windows)
        for k, a, b in wins:
            self._repack(k, a, b)
        self.last_word_windows = wins
        self.last_x_windows = self.inner.last_x_windows


class PackedBlockMirror:
    """Host mirror of a ``PackedBlockRMQ``: raw ``BlockMirror`` + word planes.

    The raw mirrors are derived from the built packed state (exact decode:
    the word planes' index fields are exact, and level 0 of ``stw`` carries
    every per-block leftmost minimum). ``block_words`` is ``None`` for the
    quantized layout — its first tier stays raw and ``inner.x_blocks`` is
    the publishable leaf itself.
    """

    def __init__(self, blocks: np.ndarray, stw: np.ndarray, spec, n: int):
        self.spec = spec
        self.stw_words = np.array(stw)
        dtype = np.dtype(spec.dtype)
        if spec.layout == "quantized":
            self.block_words: Optional[np.ndarray] = None
            x_blocks = np.array(blocks)
        else:
            wb = np.asarray(blocks)
            self.block_words = np.array(wb)
            x_blocks = np.where(
                wb == packing.pad_word(spec),
                np_maxval(dtype),
                packing.unpack_val_np(spec, wb),
            ).astype(dtype)
        bs = x_blocks.shape[1]
        bmin_gidx = packing.unpack_idx_np(spec, self.stw_words[0])
        bmin_val = x_blocks.reshape(-1)[bmin_gidx]
        # stw index fields are *global element* indices in every layout; the
        # block id they live in is the exact block-level argmin (word-min
        # ties resolve to the smaller global index = the leftmost block).
        st_idx = packing.unpack_idx_np(spec, self.stw_words) // bs
        self.inner = BlockMirror(x_blocks, bmin_val, bmin_gidx, st_idx, n)
        self.last_block_runs: Optional[List[Tuple[int, int]]] = None
        self.last_st_windows: Optional[List[Tuple[int, int, int]]] = None

    @classmethod
    def from_state(cls, s, spec, n: int) -> "PackedBlockMirror":
        return cls(np.asarray(s.blocks), np.asarray(s.stw), spec, n)

    def _repack_block_rows(self, a: int, b: int) -> None:
        inner = self.inner
        bs = inner.block_size
        rows = inner.x_blocks[a : b + 1]
        gidx = (
            np.arange(a, b + 1, dtype=np.int64)[:, None] * bs
            + np.arange(bs, dtype=np.int64)[None, :]
        )
        flat_v = rows.reshape(-1)
        flat_i = gidx.reshape(-1)
        valid = flat_i < inner.n
        words = np.full(
            flat_v.shape, packing.pad_word(self.spec), packing.word_dtype_np(self.spec)
        )
        words[valid] = packing.pack_np(
            self.spec, flat_v[valid], flat_i[valid].astype(np.int32)
        )
        self.block_words[a : b + 1] = words.reshape(rows.shape)

    def _repack_stw(self, k: int, a: int, b: int) -> None:
        inner = self.inner
        blk = inner.st_idx[k, a : b + 1]
        self.stw_words[k, a : b + 1] = packing.pack_np(
            self.spec, inner.bmin_val[blk], inner.bmin_gidx[blk]
        )

    def patch(self, batch: DeltaBatch) -> None:
        inner = self.inner
        inner.patch(batch)
        if inner.last_block_runs is None:  # block count grew: shapes changed
            nb = inner.x_blocks.shape[0]
            if self.block_words is not None:
                self.block_words = np.empty(
                    inner.x_blocks.shape, packing.word_dtype_np(self.spec)
                )
                self._repack_block_rows(0, nb - 1)
            self.stw_words = packing.pack_np(
                self.spec,
                inner.bmin_val[inner.st_idx],
                inner.bmin_gidx[inner.st_idx],
            )
            self.last_block_runs = None
            self.last_st_windows = None
            return
        if self.block_words is not None:
            for a, b in inner.last_block_runs:
                self._repack_block_rows(a, b)
        # Level 0 of stw is the per-block-minimum word row: touched blocks
        # re-encode even when the block-level argmin table did not move.
        wins = [(0, a, b) for a, b in inner.last_block_runs]
        wins.extend(inner.last_st_windows)
        for k, a, b in wins:
            self._repack_stw(k, a, b)
        self.last_block_runs = inner.last_block_runs
        self.last_st_windows = wins
