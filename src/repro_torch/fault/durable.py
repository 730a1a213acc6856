"""DurableEngine: WAL-journaled, checkpointable wrapper over an OnlineEngine.

The crash-safety contract, end to end:

* **Journal before apply.** Every update batch is coalesced, assigned the
  next sequence number, and durably appended to the write-ahead journal
  (``fault.wal.Journal``) *before* any engine mirror is touched. A process
  death at any later point loses nothing: the batch replays on restore.
* **Atomic checkpoints.** ``checkpoint()`` snapshots the engine's structure
  leaves + version id + covered seq through
  ``checkpoint.store.save_snapshot`` (write-temp-fsync-rename) and then
  compacts the journal up to that seq. A base checkpoint is written at
  construction, so restore always has a floor.
* **Restore = checkpoint + journal suffix.** ``DurableEngine.restore(root)``
  loads the latest complete checkpoint, re-seats the engine's leaves on
  ``device`` (``OnlineEngine.from_snapshot``: no argmin is rebuilt, and the
  first version is published only once its uploads are complete) and
  replays journal records with ``seq >`` the checkpoint's. Replay is
  idempotent (seq dedup) and skips aborted seqs, so the result is
  bit-identical to the never-crashed state and version ids continue the
  original timeline.
* **Poison clears on recovery.** A mid-patch failure fail-stops the inner
  engine (``update.EnginePoisoned`` carries the cause + failing seq) and the
  failing seq gets an abort marker; ``recover()`` re-restores in place —
  the replayed engine skips the aborted update and serves cleanly.

``DurableEngine`` quacks like an ``OnlineEngine`` for serving
(``pin``/``release``/``query``/``apply``/``n``/``current_vid``/``device``),
so ``serve.RMQServer(online=...)`` takes either interchangeably.

A mesh engine (``distributed``, ``sharded_hybrid``,
``packed_sharded_hybrid``) takes ``mesh``/``axis_names`` in place of
``device`` in ``create``, ``restore`` and ``recover``; its checkpoint is the
logical array only, and a restore re-runs the BuildPlan over it.

Port of ``repro/fault/durable.py``: the on-disk root (journal and
checkpoints) is the reference's, byte for byte, so either package restores
the other's.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

from repro_torch import checkpoint as checkpoint_mod
from repro_torch.obs import trace as obs_trace
from repro_torch.update.deltas import DeltaLog
from repro_torch.update.engines import OnlineEngine

from .wal import Journal

__all__ = ["DurableEngine"]

_CKPT_SUBDIR = "ckpt"
_JOURNAL_FILE = "journal.wal"


def _fault_fn(fault) -> Optional[Callable[[str], None]]:
    """Accept a FaultPlan or a bare ``check(site)`` callable."""
    if fault is None:
        return None
    return fault.check if hasattr(fault, "check") else fault


class DurableEngine:
    """Crash-safe shell around one ``OnlineEngine`` rooted at a directory.

    Layout: ``<root>/journal.wal`` + ``<root>/ckpt/step_<seq>/``. Use
    ``create`` for a fresh engine, ``restore`` after a crash; the plain
    constructor wraps an already-built engine (seq state is taken from the
    journal on disk).
    """

    def __init__(self, online: OnlineEngine, root: str, *, fault=None, _seq: int = 0):
        os.makedirs(root, exist_ok=True)
        self.online = online
        self.root = root
        self._fault = _fault_fn(fault)
        self.journal = Journal(os.path.join(root, _JOURNAL_FILE), fault=self._fault)
        self._lock = threading.Lock()
        # Seqs are never reused — count aborts and compacted records too, or
        # a recovered engine could shadow a fresh update behind a stale abort
        # marker.
        self._seq = max(int(_seq), self.journal.last_seq)
        self.replayed = 0  # journal records re-applied by the last restore

    # -- construction ---------------------------------------------------------

    @classmethod
    def create(
        cls,
        name: str,
        x,
        root: str,
        *,
        device=None,
        mesh=None,
        axis_names=None,
        fault=None,
        **build_kw,
    ) -> "DurableEngine":
        """Build engine ``name`` over ``x`` on ``device`` (a mesh engine: on
        ``mesh``) with durability rooted at ``root``."""
        online = OnlineEngine(name, x, device=device, mesh=mesh, axis_names=axis_names, **build_kw)
        d = cls(online, root, fault=fault)
        if checkpoint_mod.latest_step(d.ckpt_dir) is None:
            d.checkpoint()  # durable base: restore always has a floor
        return d

    @classmethod
    def restore(cls, root: str, *, device=None, mesh=None, axis_names=None, fault=None) -> "DurableEngine":
        """Latest checkpoint + journal-suffix replay -> a consistent engine.

        Bit-identical to the never-crashed state: the checkpoint was taken
        under the apply lock, replayed batches are exactly the journaled
        suffix in seq order (deduped, aborts skipped), and each replayed
        apply runs the same patch path the original did. Idempotent —
        restoring twice (or restoring a restored root) converges on the same
        state and seq.
        """
        ckpt = os.path.join(root, _CKPT_SUBDIR)
        arrays, meta, _ = checkpoint_mod.load_snapshot(ckpt)
        online = OnlineEngine.from_snapshot(arrays, meta, device=device, mesh=mesh, axis_names=axis_names)
        d = cls(online, root, fault=fault, _seq=int(meta["seq"]))
        tr = obs_trace.get_tracer()
        with tr.span("restore", attrs={"root": root} if tr.enabled else None):
            for seq, batch in d.journal.replay(after_seq=int(meta["seq"])):
                online.apply(batch, seq=seq)
                d.replayed += 1
        return d

    def recover(self, *, device=None, mesh=None, axis_names=None) -> int:
        """In-place crash recovery; returns the number of replayed records.

        Replaces the inner engine with a restore of this root — the
        supported way to clear a poisoned (fail-stopped) applier: the failed
        update was abort-marked, so the replayed engine lands on the last
        published version and accepts new updates again. With neither
        ``device`` nor ``mesh`` it restores where the inner engine lives
        (its mesh, or its device).
        """
        with self._lock:
            if device is None and mesh is None:
                if self.online.mesh is not None:
                    mesh, axis_names = self.online.mesh, self.online.axis_names
                else:
                    device = self.online.device
            fresh = DurableEngine.restore(self.root, device=device, mesh=mesh, axis_names=axis_names)
            fresh.journal.close()
            self.online = fresh.online
            self._seq = max(self._seq, fresh._seq)
            self.replayed = fresh.replayed
            return fresh.replayed

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.root, _CKPT_SUBDIR)

    @property
    def seq(self) -> int:
        """Sequence number of the last journaled update (0 = none yet)."""
        with self._lock:
            return self._seq

    # -- durability -----------------------------------------------------------

    def apply(self, deltas, *, observer: Optional[Callable] = None):
        """Journal the coalesced batch durably, then apply it.

        The WAL append (fsynced) happens before the first mirror write, so a
        crash anywhere inside the apply loses nothing — restore replays the
        batch. If the apply itself fails, the seq is abort-marked: replay
        must not re-attempt a batch that already failed deterministically
        (malformed bounds) or re-poison a restored engine. Should the abort
        write die too (a real crash), replay re-applies the batch and
        reaches the same outcome — apply is deterministic.
        """
        tr = obs_trace.get_tracer()
        with self._lock:
            if isinstance(deltas, DeltaLog):
                batch = deltas.coalesce(self.online.n, dtype=self.online.dtype)
            else:
                batch = deltas
            seq = self._seq + 1
            with tr.span("journal_append", attrs={"seq": seq} if tr.enabled else None):
                self.journal.append(seq, batch)  # WAL: durable BEFORE any mutation
            self._seq = seq
            obs = self._observer(observer)
            try:
                return self.online.apply(batch, observer=obs, seq=seq)
            except BaseException:
                try:
                    self.journal.abort(seq)
                except BaseException:
                    pass  # crash-during-abort: at-least-once replay, see above
                raise

    def _observer(self, user_obs: Optional[Callable]) -> Optional[Callable]:
        """Compose the stage observers: user first, then tracing, then the
        patch_apply fault site.

        The fault site fires after the ``apply_deltas`` stage (mirrors
        patched) and before ``publish`` — the mirrors-diverged-from-
        published-chain window the fail-stop + restore machinery exists for.
        The trace marker lands at the same boundary so an exported trace
        shows exactly where injection can strike; injection firing LAST means
        the user observer and the trace marker still see a stage that
        completed, even on the apply that gets killed.
        """
        user_fires = user_obs is not None
        trace_fires = obs_trace.get_tracer().enabled
        fault_fires = self._fault is not None
        if not (trace_fires or fault_fires):
            return user_obs

        def obs(stage: str, state: dict):
            if user_fires:
                user_obs(stage, state)
            if stage == "apply_deltas":
                if trace_fires:
                    obs_trace.get_tracer().instant("patch_applied", attrs={"seq": self._seq})
                if fault_fires:
                    self._fault("patch_apply")

        return obs

    def checkpoint(self) -> dict:
        """Snapshot the current version atomically; compact the journal.

        Returns the checkpoint meta. Refuses on a poisoned engine
        (``snapshot()`` raises — a diverged mirror must never become the
        durable base). If the checkpoint write itself fails, the journal is
        left uncompacted: restore falls back to the previous checkpoint plus
        a longer replay suffix, still exact.
        """
        tr = obs_trace.get_tracer()
        with self._lock:
            with tr.span("checkpoint", attrs={"seq": self._seq} if tr.enabled else None):
                arrays, meta = self.online.snapshot()
                meta["seq"] = self._seq
                checkpoint_mod.save_snapshot(self.ckpt_dir, self._seq, arrays, meta, fault=self._fault)
                self.journal.truncate_upto(self._seq)
            return meta

    def close(self) -> None:
        self.journal.close()

    # -- OnlineEngine serving surface -----------------------------------------

    @property
    def name(self) -> str:
        return self.online.name

    @property
    def spec(self):
        return self.online.spec

    @property
    def plan(self):
        return self.online.plan

    @property
    def store(self):
        return self.online.store

    @property
    def device(self):
        return self.online.device

    @property
    def mesh(self):
        return self.online.mesh

    @property
    def axis_names(self):
        return self.online.axis_names

    @property
    def n(self) -> int:
        return self.online.n

    @property
    def current_vid(self) -> int:
        return self.online.current_vid

    @property
    def dtype(self):
        return self.online.dtype

    @property
    def poisoned(self) -> bool:
        return self.online.poisoned

    def pin(self):
        return self.online.pin()

    def release(self, vid: int) -> None:
        self.online.release(vid)

    def query(self, state, l, r):
        return self.online.query(state, l, r)
