"""Versioned online-update subsystem: mutate RMQ structures under live traffic.

Point writes, range writes and appends coalesce into delta batches
(``deltas``); windowed recompute on host mirrors patches only the affected
block minima and doubling-table windows (``patch``); copy-on-write MVCC
snapshots (``versions``) let queries pin a consistent version while updates
publish the next one, so serving never blocks on mutation.

``make_online`` wraps any registry engine marked ``updatable``;
``serve.RMQServer(online=...)`` accepts the result and interleaves
``submit_update`` batches with query launches. Port of ``repro/update``
for the single-host engines: ``deltas``, ``versions`` and ``patch`` are
copies of the reference's modules, ``engines`` publishes torch tensors.
"""

from .deltas import Delta, DeltaBatch, DeltaLog, shard_batches
from .engines import (
    EnginePoisoned,
    OnlineEngine,
    UpdateResult,
    make_online,
    online_names,
)
from .patch import BlockMirror, STMirror, k_levels, level_windows, patch_doubling
from .versions import Version, VersionStore

__all__ = [
    "BlockMirror",
    "Delta",
    "DeltaBatch",
    "DeltaLog",
    "EnginePoisoned",
    "OnlineEngine",
    "STMirror",
    "UpdateResult",
    "Version",
    "VersionStore",
    "k_levels",
    "level_windows",
    "make_online",
    "online_names",
    "patch_doubling",
    "shard_batches",
]
