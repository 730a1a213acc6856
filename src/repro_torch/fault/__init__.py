"""Crash safety: WAL, checkpoints, fault injection and the degraded fallback.

Serving state must survive process death and misbehaving components without
losing an acknowledged update or returning a wrong answer:

* ``inject`` — seeded ``FaultPlan`` schedules over named sites, a copy of
  ``repro/fault/inject.py``; the machinery below fires the
  ``worker_query``, ``patch_apply``, ``checkpoint_write`` and
  ``journal_append`` sites at the instants it is most exposed.
* ``wal`` — the append-only, checksummed, seq-numbered delta journal (a
  copy of the reference's). Torn tails (a crash mid-append) are detected
  and dropped on scan; replay dedups seqs and skips abort markers.
* ``durable`` — ``DurableEngine``: journal-before-apply over any updatable
  ``OnlineEngine``, atomic structure checkpoints, restore = checkpoint +
  journal-suffix replay (bit-identical to the never-crashed state). The
  on-disk root is the reference's, so either package restores the other's.
* ``fallback`` — ``DegradedFallback``: the plain sparse-table engine the
  serve circuit breaker of an online server routes to while the primary
  keeps failing, built from the pinned version's host array.
* ``chaos`` (not imported here — it pulls in ``repro_torch.serve``; run it
  as ``python -m repro_torch.fault.chaos``) — the seeded mutate-while-serving
  soak that kills workers, fails patches and checkpoints, and crash-restores
  mid-stream while oracle-verifying every response against its pinned
  version.
"""

from .inject import SITES, FaultPlan, FaultSpec, InjectedFault
from .wal import Journal
from .durable import DurableEngine
from .fallback import DegradedFallback

__all__ = [
    "SITES",
    "DegradedFallback",
    "DurableEngine",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "Journal",
]
