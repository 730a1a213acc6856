"""Write-ahead delta journal: seq-numbered, checksummed, torn-tail tolerant.

Durability contract of the online-update path: every coalesced ``DeltaBatch``
is appended (and fsynced) here *before* any engine mirror is touched, so the
update stream survives a process death at any point. Recovery is

    latest checkpoint  +  replay of the journal suffix (seq > checkpoint seq)

which ``fault.durable.DurableEngine`` makes bit-identical to the
never-crashed state: replay skips seqs the checkpoint already covers
(idempotence under repeated restore) and seqs with an abort marker (batches
that were journaled but whose apply failed — replaying them would fail, or
worse, publish a version the original timeline never had).

Record format (little-endian, append-only):

    4s  magic   b"RMQW"
    B   kind    0 = data, 1 = abort marker
    Q   seq     update sequence number (1-based; checkpoint base is seq 0)
    Q   len     payload length in bytes (0 for abort markers)
    I   crc32   of the payload
    len bytes   npz-serialized DeltaBatch (``DeltaBatch.to_bytes``)

A scan stops at the first incomplete/garbled record: bytes after a torn
write are unreachable by construction (a crash mid-append cannot corrupt
records already on disk — it can only leave a partial tail, which the next
append truncates away). Compaction after a checkpoint (``truncate_upto``)
rewrites the suffix through a temp file + fsync + rename, so it is itself
crash-atomic.

A copy of ``repro/fault/wal.py`` (no framework code): the same records,
byte for byte, so either package replays the other's journal.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Callable, List, Optional, Tuple

from repro_torch.update.deltas import DeltaBatch

from .inject import InjectedFault

__all__ = ["Journal"]

_MAGIC = b"RMQW"
_HDR = struct.Struct("<4sBQQI")  # magic, kind, seq, payload_len, crc32
_DATA, _ABORT = 0, 1


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Journal:
    """Append-only WAL over ``DeltaBatch`` records.

    ``fault`` is an optional ``check(site)`` callable (a ``FaultPlan``'s
    bound method) fired mid-append at the ``journal_append`` site: a
    ``"crash"`` leaves a torn record on disk exactly like a real process
    death between ``write`` and ``fsync``; an ``"error"`` rolls the file
    back to the pre-append offset (a cleanly failed append).
    """

    def __init__(self, path: str, *, fault: Optional[Callable[[str], None]] = None):
        self.path = path
        self._fault = fault
        self._lock = threading.Lock()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a+b")
        _, self._end, self._last_seq = self._read_records()

    # -- reading --------------------------------------------------------------

    def _read_records(self) -> Tuple[List[Tuple[int, Optional[DeltaBatch]]], int, int]:
        """(records, valid_end_offset, max_seq) — stops at the torn tail.

        Records are ``(seq, batch)`` with ``batch=None`` for abort markers.
        ``max_seq`` covers aborts too: sequence numbers are never reused,
        even for failed updates, or an old abort marker could shadow a new
        data record at replay.
        """
        try:
            with open(self.path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            return [], 0, 0
        recs: List[Tuple[int, Optional[DeltaBatch]]] = []
        off, last = 0, 0
        while off + _HDR.size <= len(data):
            magic, kind, seq, plen, crc = _HDR.unpack_from(data, off)
            if magic != _MAGIC or kind not in (_DATA, _ABORT):
                break
            end = off + _HDR.size + plen
            if end > len(data):
                break  # torn write: the record never finished
            payload = data[off + _HDR.size : end]
            if kind == _DATA:
                if zlib.crc32(payload) != crc:
                    break  # garbled payload: treat like a torn tail
                recs.append((int(seq), DeltaBatch.from_bytes(payload)))
            else:
                recs.append((int(seq), None))
            off = end
            last = max(last, int(seq))
        return recs, off, last

    def scan(self) -> List[Tuple[int, Optional[DeltaBatch]]]:
        """All complete records in order; ``None`` batch = abort marker."""
        recs, _, _ = self._read_records()
        return recs

    def replay(self, after_seq: int) -> List[Tuple[int, DeltaBatch]]:
        """Data records to re-apply on restore, in order.

        Drops seqs the checkpoint covers (``<= after_seq``), seqs with an
        abort marker anywhere in the journal, and duplicates — so replaying
        a journal any number of times converges on the same state.
        """
        recs = self.scan()
        aborted = {seq for seq, batch in recs if batch is None}
        out: List[Tuple[int, DeltaBatch]] = []
        seen = set()
        for seq, batch in recs:
            if batch is None or seq <= after_seq or seq in aborted or seq in seen:
                continue
            seen.add(seq)
            out.append((seq, batch))
        return out

    @property
    def last_seq(self) -> int:
        """Highest sequence number on disk (data or abort; 0 = empty)."""
        with self._lock:
            return self._last_seq

    # -- writing --------------------------------------------------------------

    def append(self, seq: int, batch: DeltaBatch) -> None:
        """Durably append one data record (flush + fsync before returning)."""
        payload = batch.to_bytes()
        hdr = _HDR.pack(_MAGIC, _DATA, seq, len(payload), zlib.crc32(payload))
        self._write_record(hdr, payload, seq)

    def abort(self, seq: int) -> None:
        """Mark ``seq`` as journaled-but-not-applied: replay will skip it."""
        self._write_record(_HDR.pack(_MAGIC, _ABORT, seq, 0, 0), b"", seq)

    def _write_record(self, hdr: bytes, payload: bytes, seq: int) -> None:
        with self._lock:
            f = self._f
            # Discard any torn tail a previous crash left: appending after it
            # would strand the new record behind unparseable bytes.
            f.truncate(self._end)
            f.seek(self._end)
            half = len(payload) // 2
            try:
                f.write(hdr)
                f.write(payload[:half])
                if self._fault is not None:
                    # Mid-record: a "crash" here is a torn write on disk.
                    self._fault("journal_append")
                f.write(payload[half:])
                f.flush()
                os.fsync(f.fileno())
            except InjectedFault as e:
                f.flush()
                if e.kind != "crash":
                    f.truncate(self._end)  # transient error: clean rollback
                raise
            except BaseException:
                f.flush()
                f.truncate(self._end)
                raise
            self._end += len(hdr) + len(payload)
            self._last_seq = max(self._last_seq, int(seq))

    def truncate_upto(self, seq: int) -> None:
        """Compact away records with ``seq <=`` the given checkpoint seq.

        Atomic (write temp, fsync, rename): a crash mid-compaction leaves
        either the old journal or the new one, never a mix. Abort markers
        above the checkpoint are preserved — replay still needs them.
        """
        with self._lock:
            recs, _, _ = self._read_records()
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as g:
                for s, batch in recs:
                    if s <= seq:
                        continue
                    if batch is None:
                        g.write(_HDR.pack(_MAGIC, _ABORT, s, 0, 0))
                    else:
                        payload = batch.to_bytes()
                        g.write(_HDR.pack(_MAGIC, _DATA, s, len(payload), zlib.crc32(payload)))
                        g.write(payload)
                g.flush()
                os.fsync(g.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            _fsync_dir(os.path.dirname(self.path) or ".")
            self._f = open(self.path, "a+b")
            _, self._end, tail_seq = self._read_records()
            # Numbering continues past compacted records: seqs are never reused.
            self._last_seq = max(self._last_seq, tail_seq, int(seq))

    def close(self) -> None:
        with self._lock:
            self._f.close()
