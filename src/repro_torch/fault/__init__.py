"""Crash safety: fault injection and the degraded fallback.

* ``inject`` — seeded ``FaultPlan`` schedules over named sites, a copy of
  ``repro/fault/inject.py``; the serve worker pool fires the
  ``worker_query`` site.
* ``fallback`` — ``DegradedFallback``: the plain sparse-table engine the
  serve circuit breaker of an online server routes to while the primary
  keeps failing, built from the pinned version's host array.

The WAL, checkpoints and the durable engine are a later slice (ROADMAP.md).
"""

from .fallback import DegradedFallback
from .inject import SITES, FaultPlan, FaultSpec, InjectedFault

__all__ = ["SITES", "DegradedFallback", "FaultPlan", "FaultSpec", "InjectedFault"]
