"""Deterministic fault injection: a seeded ``FaultPlan`` over named sites.

The crash-safety layer is only as trustworthy as the failures it has been
exercised against, so faults are injected *deterministically*: a
``FaultPlan`` carries one seeded RNG per site plus a thread-safe invocation
counter, and every instrumented code path calls ``plan.check(site)`` at the
point where that class of failure would strike. A firing check raises
``InjectedFault`` — the production code must treat it exactly like the real
failure (there is no test-only branch downstream of the raise).

Sites (who calls ``check`` where):

* ``worker_query`` — the serve worker pool, immediately before each engine
  launch (``serve.server.RMQServer``). ``kind="crash"`` additionally kills
  the worker thread after its batch is failed/retried, exercising the
  supervisor restart path.
* ``patch_apply`` — the ``apply_deltas`` stage observer of the online-update
  pipeline (``fault.durable.DurableEngine``): the patch ran, the publish has
  not — the mirrors-diverged-from-published-chain crash the fail-stop +
  journal-replay recovery exists for.
* ``checkpoint_write`` — inside ``checkpoint.store.save`` between the leaf
  writes and the manifest/rename: a torn temp directory that restore must
  ignore.
* ``journal_append`` — mid-record inside ``fault.wal.Journal.append``: a
  ``"crash"`` leaves torn bytes on disk (recovery stops at the last complete
  record); an ``"error"`` is rolled back to the pre-append offset and
  surfaces as a failed update.
* ``rollout_apply`` — the fleet front door (``serve.fleet.RMQFleet``),
  immediately before handing a rollout's update batch to one replica's
  server: a replica crash mid-rollout, exercising the crash -> restore ->
  rejoin-at-fleet-vid path.

``FaultSpec.at`` fires at exact 1-based invocation counts (fully
deterministic regardless of thread interleaving); ``rate`` fires
probabilistically from the per-site seeded stream (deterministic given a
fixed invocation order, statistically reproducible otherwise).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np

__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "SITES"]

SITES: Tuple[str, ...] = (
    "worker_query",
    "patch_apply",
    "checkpoint_write",
    "journal_append",
    "rollout_apply",
)

_KINDS = ("error", "crash")


class InjectedFault(RuntimeError):
    """One injected failure. ``kind="error"`` models a transient fault (the
    operation failed cleanly, a retry may succeed); ``kind="crash"`` models a
    process/thread death at that point (torn on-disk bytes, a dead worker)."""

    def __init__(self, site: str, count: int, kind: str):
        super().__init__(f"injected {kind} fault at {site} (invocation {count})")
        self.site = site
        self.count = count
        self.kind = kind


class FaultSpec(NamedTuple):
    """When one site fires: exact invocation counts and/or a probability."""

    rate: float = 0.0  # per-invocation firing probability
    at: Tuple[int, ...] = ()  # exact 1-based invocation counts that fire
    kind: str = "error"  # "error" (transient) | "crash" (process death)


class FaultPlan:
    """Seeded, thread-safe fault schedule over the named ``SITES``."""

    def __init__(
        self,
        seed: int = 0,
        specs: Optional[Mapping[str, Union[FaultSpec, dict]]] = None,
    ):
        self.seed = int(seed)
        self._specs: Dict[str, FaultSpec] = {}
        for site, spec in (specs or {}).items():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}; have {SITES}")
            if isinstance(spec, dict):
                spec = FaultSpec(**spec)
            if spec.kind not in _KINDS:
                raise ValueError(f"fault kind must be one of {_KINDS}, got {spec.kind!r}")
            if not 0.0 <= spec.rate <= 1.0:
                raise ValueError(f"fault rate must be in [0, 1], got {spec.rate}")
            self._specs[site] = spec._replace(at=tuple(int(c) for c in spec.at))
        self._lock = threading.Lock()
        self._hits = {s: 0 for s in SITES}
        self._fired = {s: 0 for s in SITES}
        # One independent stream per site, derived from the plan seed: adding
        # a spec for one site never shifts another site's draw sequence.
        self._rngs = {s: np.random.default_rng([self.seed, i]) for i, s in enumerate(SITES)}

    def check(self, site: str) -> None:
        """Count one invocation of ``site``; raise ``InjectedFault`` if it fires."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; have {SITES}")
        with self._lock:
            self._hits[site] += 1
            count = self._hits[site]
            spec = self._specs.get(site)
            if spec is None:
                return
            fire = count in spec.at or (
                spec.rate > 0.0 and self._rngs[site].random() < spec.rate
            )
            if fire:
                self._fired[site] += 1
                raise InjectedFault(site, count, spec.kind)

    def hook(self, site: str) -> Callable[[], None]:
        """A no-argument closure of ``check(site)`` for single-site seams."""
        return lambda: self.check(site)

    def hits(self) -> Dict[str, int]:
        """Invocations per site so far (fired or not)."""
        with self._lock:
            return dict(self._hits)

    def fired(self) -> Dict[str, int]:
        """Faults actually raised per site so far."""
        with self._lock:
            return dict(self._fired)
