"""Fault injection (``inject``): seeded ``FaultPlan`` schedules over named sites.

A copy of ``repro/fault/inject.py``; the serve worker pool fires the
``worker_query`` site. The WAL, checkpoints and the durable engine are a
later slice (ROADMAP.md).
"""

from .inject import SITES, FaultPlan, FaultSpec, InjectedFault

__all__ = ["SITES", "FaultPlan", "FaultSpec", "InjectedFault"]
