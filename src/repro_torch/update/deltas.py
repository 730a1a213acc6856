"""Delta log: the mutation vocabulary of the online-update subsystem.

Mutable-array RMQ workloads (streaming telemetry, order books, sliding
windows) express three mutations: point writes, contiguous range writes, and
appends. ``DeltaLog`` records them in arrival order; ``coalesce`` lowers the
log into one canonical ``DeltaBatch`` — last-write-wins in-place writes over
the existing prefix plus a single appended tail — which is what the patch
kernels consume. Coalescing here is what keeps incremental recompute cheap:
k writes to one hot position cost one block-min repair, not k, and a write
landing inside a just-appended region folds into the tail instead of
becoming a second patch pass.

``shard_batches`` splits a coalesced batch by structure-shard ownership (the
``ShardLayout`` geometry) — the accounting view behind
``UpdateResult.touched_shards`` (the SPMD kernels themselves scatter
replicated update arrays inside ``shard_map``).

Everything here is host-side numpy: deltas arrive from clients exactly like
query bounds do, and the patch planner needs the touched positions on the
host anyway (window math is static per patch).

A copy of ``repro/update/deltas.py``: numpy only, so the port carries it
over unchanged instead of importing the reference.
"""

from __future__ import annotations

import io
from typing import List, NamedTuple, Tuple

import numpy as np

__all__ = ["Delta", "DeltaBatch", "DeltaLog", "shard_batches"]


class Delta(NamedTuple):
    """One logged mutation, in arrival order."""

    kind: str  # "point" | "write" | "append"
    pos: int  # start index (ignored for append)
    values: np.ndarray  # (1,) point / (len,) contiguous write / (len,) tail


class DeltaBatch(NamedTuple):
    """A coalesced update batch: the canonical input of the patch kernels.

    ``idx``/``val`` are last-write-wins in-place writes into ``[0, n_old)``
    (``idx`` sorted ascending, unique); ``tail`` is the appended suffix
    (writes into the appended region are already folded in). The mutated
    array is ``concat(x[:n_old] with idx<-val scattered, tail)``.
    """

    idx: np.ndarray  # (W,) int64 sorted unique write positions < n_old
    val: np.ndarray  # (W,) values to scatter at idx
    tail: np.ndarray  # (A,) appended values (n_new = n_old + A)
    n_old: int
    n_new: int

    @property
    def n_ops(self) -> int:
        return int(self.idx.size + self.tail.size)

    def touched(self) -> np.ndarray:
        """Sorted global positions whose value changes (writes + tail)."""
        return np.concatenate(
            [self.idx, np.arange(self.n_old, self.n_new, dtype=np.int64)]
        )

    def apply_numpy(self, x: np.ndarray) -> np.ndarray:
        """The oracle semantics: the mutated array, as plain numpy."""
        if x.shape[0] != self.n_old:
            raise ValueError(f"batch coalesced for n={self.n_old}, got {x.shape[0]}")
        out = np.concatenate([x, self.tail.astype(x.dtype)])
        out[self.idx] = self.val.astype(x.dtype)
        return out

    def to_bytes(self) -> bytes:
        """Serialize for the write-ahead journal (``repro.fault.wal``).

        npz keeps exact dtypes and shapes, so a journal round-trip replays
        bit-identically: ``from_bytes(b.to_bytes()).apply_numpy(x)`` equals
        ``b.apply_numpy(x)`` leaf-for-leaf.
        """
        bio = io.BytesIO()
        np.savez(
            bio,
            idx=self.idx,
            val=self.val,
            tail=self.tail,
            dims=np.asarray([self.n_old, self.n_new], np.int64),
        )
        return bio.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DeltaBatch":
        """Inverse of ``to_bytes``."""
        with np.load(io.BytesIO(raw)) as z:
            dims = z["dims"]
            return cls(
                idx=z["idx"],
                val=z["val"],
                tail=z["tail"],
                n_old=int(dims[0]),
                n_new=int(dims[1]),
            )


class DeltaLog:
    """Arrival-ordered mutation log over a length-``n`` array.

    The log itself is append-only and cheap; all normalization (bounds
    checks aside) happens in ``coalesce``. One log = one update batch = one
    published version downstream.
    """

    def __init__(self):
        self._ops: List[Delta] = []

    def __len__(self) -> int:
        return len(self._ops)

    @property
    def ops(self) -> Tuple[Delta, ...]:
        return tuple(self._ops)

    def point(self, i: int, v) -> "DeltaLog":
        """Write one value at index ``i``."""
        if i < 0:
            raise ValueError(f"point write at negative index {i}")
        self._ops.append(Delta("point", int(i), np.asarray([v])))
        return self

    def write(self, l: int, values) -> "DeltaLog":
        """Write a contiguous run of values starting at index ``l``."""
        values = np.asarray(values)
        if values.ndim != 1 or values.size == 0:
            raise ValueError(f"write needs a non-empty 1-D run, got {values.shape}")
        if l < 0:
            raise ValueError(f"range write at negative index {l}")
        self._ops.append(Delta("write", int(l), values))
        return self

    def fill(self, l: int, r: int, v) -> "DeltaLog":
        """Write the constant ``v`` over the inclusive range ``[l, r]``."""
        if not 0 <= l <= r:
            raise ValueError(f"fill needs 0 <= l <= r, got [{l}, {r}]")
        return self.write(l, np.full(r - l + 1, v))

    def append(self, values) -> "DeltaLog":
        """Extend the array with ``values`` (n grows by ``len(values)``)."""
        values = np.asarray(values)
        if values.ndim != 1 or values.size == 0:
            raise ValueError(f"append needs a non-empty 1-D run, got {values.shape}")
        self._ops.append(Delta("append", 0, values))
        return self

    def coalesce(self, n: int, dtype=np.float32) -> DeltaBatch:
        """Lower the log to one canonical ``DeltaBatch`` over a length-``n`` array.

        Replays ops in arrival order into (sparse writes over the prefix,
        dense tail), so later writes win and writes into appended positions
        fold into the tail. Raises on writes past the (current, possibly
        already-extended) end — a delta log never creates holes.
        """
        if not self._ops:
            raise ValueError("coalesce() on an empty DeltaLog")
        n = int(n)
        pos_runs: List[np.ndarray] = []
        val_runs: List[np.ndarray] = []
        tail = np.zeros(0, dtype)
        n_cur = n
        for op in self._ops:
            if op.kind == "append":
                tail = np.concatenate([tail, op.values.astype(dtype)])
                n_cur = n + tail.size
                continue
            lo = op.pos
            hi = lo + op.values.size - 1
            if hi >= n_cur:
                raise ValueError(
                    f"{op.kind} over [{lo}, {hi}] past the end of the "
                    f"length-{n_cur} array (appends extend it first)"
                )
            pos_runs.append(np.arange(lo, hi + 1, dtype=np.int64))
            val_runs.append(op.values.astype(dtype))
        if pos_runs:
            # Last write wins: unique over the REVERSED stream keeps, for each
            # position, its final value; np.unique also sorts the positions.
            pos = np.concatenate(pos_runs)[::-1]
            val = np.concatenate(val_runs)[::-1]
            uniq, first = np.unique(pos, return_index=True)
            vals = val[first]
            in_tail = uniq >= n
            tail[uniq[in_tail] - n] = vals[in_tail]
            idx, val = uniq[~in_tail], vals[~in_tail]
        else:
            idx = np.zeros(0, np.int64)
            val = np.zeros(0, dtype)
        return DeltaBatch(idx=idx, val=val, tail=tail, n_old=n, n_new=n_cur)


def shard_batches(
    batch: DeltaBatch, num_shards: int, shard_len: int
) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Split a coalesced batch's changed positions by structure-shard owner.

    Returns ``[(shard_id, global_positions, values), ...]`` for shards that
    own at least one changed position (tail values included — an append
    within the padded capacity is just writes at pad columns). The SPMD
    patch kernels scatter replicated (pos, val) arrays inside ``shard_map``
    (each device drops what it doesn't own), so this split is the
    *accounting* view: ``UpdateResult.touched_shards`` reports how local an
    update was, and tooling can inspect which shards a batch lands on.
    """
    pos = batch.touched()
    vals = np.concatenate([batch.val, batch.tail.astype(batch.val.dtype)])
    out = []
    shard = pos // shard_len
    for s in range(num_shards):
        m = shard == s
        if m.any():
            out.append((s, pos[m], vals[m]))
    return out
