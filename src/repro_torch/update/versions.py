"""Copy-on-write version snapshots: MVCC for RMQ structures.

The consistency model of the online-update subsystem (the repo's first):

* Queries **pin** a version and are answered entirely against that version's
  structures — a snapshot. Mutation never blocks serving.
* An update **publishes** the next version atomically: after ``publish``
  returns, every new pin sees the new version; already-pinned queries keep
  their snapshot.
* Old versions **retire when drained**: once a superseded version's pin
  count reaches zero it is dropped from the store, releasing its structure
  arrays. Versions are copy-on-write at the array-leaf level: a publish
  installs fresh arrays for the leaves the patch rebuilt and never mutates
  a published one. (Because the doubling tables are single (K, n) arrays,
  a value change rebuilds most structure leaves today; chunking tables by
  row group for finer COW is a ROADMAP follow-up.)

Publish order is the consistency order: the server applies updates on a
single updater thread, so version ids are also the serialization of the
update stream. ``version_lag`` (current id minus a query's pinned id) is the
staleness metric the serving stats report.

A copy of ``repro/update/versions.py`` (threading only).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, NamedTuple, Optional

__all__ = ["RolloutTracker", "Version", "VersionStore"]


class Version(NamedTuple):
    """One immutable snapshot: engine state + the logical array length."""

    vid: int  # publish sequence number (0 = the initial build)
    state: Any  # engine state (registry conformance contract)
    n: int  # logical array length at this version
    # Host copy of the logical array at this version (None when the
    # publisher doesn't track one). The crash-safety layer relies on it: the
    # degraded plain sparse-table fallback builds a correct engine for any pinned
    # version from it, and oracle verification replays against it.
    x_host: Any = None


class VersionStore:
    """Thread-safe pin/publish/retire over a chain of ``Version`` snapshots.

    ``first_vid`` seats the store mid-timeline: a restored engine's first
    publish reuses the version id the checkpoint recorded, so version ids
    stay continuous across a crash (a client's pinned-vid bookkeeping never
    sees the numbering restart).
    """

    def __init__(self, first_vid: int = 0):
        if first_vid < 0:
            raise ValueError(f"first_vid must be >= 0, got {first_vid}")
        self._lock = threading.Lock()
        self._versions: Dict[int, Version] = {}
        self._pins: Dict[int, int] = {}
        self._current = int(first_vid) - 1

    @property
    def current_vid(self) -> int:
        with self._lock:
            return self._current

    @property
    def current(self) -> Version:
        with self._lock:
            if self._current < 0:
                raise RuntimeError("no version published yet")
            return self._versions[self._current]

    def live_vids(self) -> tuple:
        """Version ids still held (current + any with outstanding pins)."""
        with self._lock:
            return tuple(sorted(self._versions))

    def publish(self, state, n: int, x_host=None) -> int:
        """Install ``state`` as the next version; returns its id.

        Atomic: pins taken after return see the new version. Superseded
        versions with no outstanding pins are retired immediately.
        """
        with self._lock:
            vid = self._current + 1
            self._versions[vid] = Version(vid, state, int(n), x_host)
            self._current = vid
            self._retire_locked()
            return vid

    def pin(self) -> Version:
        """Take a snapshot reference to the current version (refcounted)."""
        with self._lock:
            if self._current < 0:
                raise RuntimeError("pin() before the first publish")
            self._pins[self._current] = self._pins.get(self._current, 0) + 1
            return self._versions[self._current]

    def release(self, vid: int) -> None:
        """Drop one pin on ``vid``; retires it if superseded and drained."""
        with self._lock:
            left = self._pins.get(vid, 0) - 1
            if left < 0:
                raise ValueError(f"release() without a pin on version {vid}")
            if left:
                self._pins[vid] = left
            else:
                self._pins.pop(vid, None)
            self._retire_locked()

    def _retire_locked(self) -> None:
        for vid in [v for v in self._versions if v != self._current]:
            if not self._pins.get(vid):
                del self._versions[vid]


class RolloutTracker:
    """Min/max version-id tracking across a fleet of version stores.

    Each replica registers under a key and notes every version it publishes;
    the tracker maintains the fleet-wide min/max vid and implements the
    **bounded-lag rollout barrier**: ``wait_to_publish(vid)`` blocks a
    leader replica until publishing ``vid`` would keep the fleet spread
    (max vid minus min vid) within ``max_lag``. Crashed replicas must
    ``deregister`` so a dead store can never wedge the barrier; they
    re-``register`` at their restored vid when they rejoin.

    The front door shares the tracker's condition variable: ``wait_for``
    lets the router sleep until some replica reaches a session's min vid
    (read-your-writes) instead of spinning.
    """

    def __init__(self, max_lag: int = 1):
        if max_lag < 1:
            raise ValueError(f"max_lag must be >= 1, got {max_lag}")
        self.max_lag = int(max_lag)
        self._cv = threading.Condition(threading.Lock())
        self._vids: Dict[Any, int] = {}
        self._max_lag_seen = 0

    def register(self, key, vid: int) -> None:
        with self._cv:
            self._vids[key] = int(vid)
            self._record_spread_locked()
            self._cv.notify_all()

    def deregister(self, key) -> None:
        with self._cv:
            self._vids.pop(key, None)
            self._cv.notify_all()

    def note(self, key, vid: int) -> None:
        """Record that replica ``key`` now serves ``vid`` (monotonic)."""
        with self._cv:
            if key not in self._vids:
                return  # deregistered (crashed) mid-publish; rejoin re-seats
            if vid > self._vids[key]:
                self._vids[key] = int(vid)
            self._record_spread_locked()
            self._cv.notify_all()

    def _record_spread_locked(self) -> None:
        if self._vids:
            spread = max(self._vids.values()) - min(self._vids.values())
            if spread > self._max_lag_seen:
                self._max_lag_seen = spread

    @property
    def max_lag_seen(self) -> int:
        """Largest fleet spread ever observed (the measured version lag)."""
        with self._cv:
            return self._max_lag_seen

    def min_vid(self) -> int:
        with self._cv:
            return min(self._vids.values()) if self._vids else -1

    def max_vid(self) -> int:
        with self._cv:
            return max(self._vids.values()) if self._vids else -1

    def vids(self) -> Dict[Any, int]:
        with self._cv:
            return dict(self._vids)

    def wait_to_publish(self, vid: int, timeout: Optional[float] = None) -> bool:
        """Block until publishing ``vid`` keeps the fleet spread <= max_lag.

        Returns False on timeout. Deregistration of a trailing replica
        unblocks waiters (its vid no longer counts toward the minimum).
        """

        def ok() -> bool:
            if not self._vids:
                return True
            return vid - min(self._vids.values()) <= self.max_lag

        with self._cv:
            return self._cv.wait_for(ok, timeout)

    def wait_for(
        self, predicate: Callable[[Dict[Any, int]], bool], timeout: Optional[float] = None
    ) -> bool:
        """Block until ``predicate({key: vid})`` holds; False on timeout."""
        with self._cv:
            return self._cv.wait_for(lambda: predicate(dict(self._vids)), timeout)
