"""Replica fleet: N ``RMQServer`` replicas behind one front door.

One server saturates one device group; the fleet carves its devices into
disjoint per-replica groups and runs a full serving stack on each, behind a
single routing front door:

* **Regime routing** — the paper's two query regimes want different hot
  pools: short ranges resolve on the blocked path, long ranges on the
  sparse-table path. Each replica declares a ``regime_affinity`` (its warmup
  runs that regime first) and the front door classifies every batch by its range lengths against the plan's
  threshold, routing short-majority batches to short-affinity replicas and
  long-majority batches to long-affinity ones, round-robin within the pool.

* **Bounded-lag rollouts** — one ``submit_update`` coalesces the delta log
  ONCE against the fleet head, assigns the next fleet version id, and fans
  the identical batch out to every replica's rollout queue. Per-replica
  rollout workers publish independently (pipelined — a fast replica never
  waits for the slowest to finish the previous version) but a
  ``RolloutTracker`` barrier keeps the fleet spread (max vid − min vid)
  within ``max_version_lag``: a leader blocks before publishing a version
  that would leave a live replica too far behind. The fleet future resolves
  at the FIRST replica publish — from that point the update is readable.

* **Read-your-writes sessions** — a ``FleetSession`` carries the highest
  version id its owner has observed (updated when the owner's update first
  publishes and on every query response). The front door never routes a
  session's query to a replica still serving an older version: candidate
  filtering + ``submit(min_version=...)``'s ``StaleVersion`` backstop, with
  a tracker wait (not a spin) when no replica is fresh enough yet. Appends
  raise the floor implicitly: a query past an old length is routed only to
  replicas that have published the growing version.

* **Crash → restore → rejoin** — durable fleets place each replica's
  ``DurableEngine`` under ``<root>/replica<i>``. A replica that dies
  mid-rollout (the ``rollout_apply`` fault site, or an external
  ``crash_replica``) deregisters from the tracker (a dead replica can never
  wedge the barrier), is restored from its checkpoint + journal, catches up
  to the fleet head by replaying the missed rollout batches from the fleet's
  history (journaling each — durability is preserved), and re-registers at
  the current head. In-flight requests on the dead replica are re-routed by
  the front door's retry layer; nothing is lost.

**Devices.** Replicas of a single-device engine each take the fleet's
``device`` (``None``: CUDA). A mesh engine's replicas take disjoint equal
groups of mesh positions, one 1-D mesh each: by default the visible CUDA
devices (raising without CUDA; at least one per replica), or an explicit
list ``devices=`` whose positions may repeat one device (``["cuda:0"] * 8``:
three replicas of two positions each on one card, the counterpart of the
reference's ``--xla_force_host_platform_device_count=8``).

Run the acceptance soak standalone, on the card or on the host::

    PYTHONPATH=src python -m repro_torch.serve.fleet --engine hybrid --replicas 3
    PYTHONPATH=src python -m repro_torch.serve.fleet --device cpu \
        --engine sharded_hybrid --replicas 3 --devices 'cpu*8'

Port of ``repro/serve/fleet.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import shutil
import sys
import tempfile
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import build as build_mod
from repro_torch.core import registry
from repro_torch.fault.durable import DurableEngine
from repro_torch.fault.inject import FaultPlan, FaultSpec
from repro_torch.launch.mesh import make_group_mesh
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry, merge_snapshots
from repro_torch.serve.server import (
    EngineFailure,
    RMQServer,
    ServeConfig,
    ServerClosed,
    ServerOverloaded,
    StaleVersion,
)
from repro_torch.update.deltas import DeltaLog
from repro_torch.update.engines import OnlineEngine, online_names
from repro_torch.update.versions import RolloutTracker

__all__ = [
    "FleetConfig",
    "FleetSession",
    "FleetSoakReport",
    "FleetStats",
    "RMQFleet",
    "cli_placement",
    "main",
    "parse_devices",
    "run_fleet_soak",
]

_STOP = object()


@dataclass(frozen=True)
class FleetConfig:
    """Fleet shape + rollout/routing policy. ``server`` is the per-replica
    ``ServeConfig`` template; its ``regime_affinity`` is overwritten per
    replica from ``affinities`` (default: alternating short/long)."""

    replicas: int = 2
    max_version_lag: int = 1  # rollout barrier: max fleet vid spread
    threshold: Optional[int] = None  # short/long routing split (default: plan meta)
    route_timeout_s: float = 30.0  # front-door wait for a fresh-enough replica
    rollout_timeout_s: float = 120.0  # per-replica barrier + publish wait
    max_route_retries: int = 2  # front-door resubmits after a replica failure
    auto_revive: bool = True  # durable fleets: restore crashed replicas in place
    server: ServeConfig = field(default_factory=ServeConfig)
    affinities: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if self.max_version_lag < 1:
            raise ValueError(f"max_version_lag must be >= 1, got {self.max_version_lag}")
        if self.route_timeout_s <= 0 or self.rollout_timeout_s <= 0:
            raise ValueError(f"timeouts must be > 0: {self}")
        if self.max_route_retries < 0:
            raise ValueError(f"max_route_retries must be >= 0, got {self.max_route_retries}")
        if self.affinities is not None:
            if len(self.affinities) != self.replicas:
                raise ValueError(
                    f"{len(self.affinities)} affinities for {self.replicas} replicas"
                )
            for a in self.affinities:
                if a not in (None, "short", "long"):
                    raise ValueError(f"affinity must be None, 'short', or 'long': {a!r}")

    def resolved_affinities(self) -> Tuple[Optional[str], ...]:
        if self.affinities is not None:
            return tuple(self.affinities)
        if self.replicas == 1:
            return (None,)
        return tuple("short" if i % 2 == 0 else "long" for i in range(self.replicas))


class FleetSession:
    """Read-your-writes token: the highest version id this client observed.

    Observed at the ack point of the client's own updates (the first replica
    publish — before the update future resolves, so a client that awaited
    its update always carries the new floor) and on every query response.
    The front door routes a session's queries only to replicas at or past
    the floor. Thread-safe and monotonic.
    """

    __slots__ = ("_lock", "_vid")

    def __init__(self):
        self._lock = threading.Lock()
        self._vid = -1  # below every published vid: no floor yet

    @property
    def last_vid(self) -> int:
        with self._lock:
            return self._vid

    def observe(self, vid: int) -> None:
        with self._lock:
            if vid > self._vid:
                self._vid = int(vid)


class _Rollout:
    """One fleet update: the coalesced batch fanned out to every replica.

    The future resolves at the FIRST successful publish (or catch-up apply);
    ``settle`` counts per-replica outcomes so an update that failed on every
    enqueued replica of a non-durable fleet fails the caller instead of
    hanging (durable fleets revive and ack through the catch-up path).
    """

    __slots__ = ("vid", "batch", "future", "session", "t_submit", "_lock", "_left", "_ok")

    def __init__(self, vid: int, batch, fanout: int, session: Optional[FleetSession]):
        self.vid = vid
        self.batch = batch
        self.future: Future = Future()
        self.session = session
        self.t_submit = time.perf_counter()
        self._lock = threading.Lock()
        self._left = fanout
        self._ok = 0

    def ack(self, result) -> None:
        # Session floor moves BEFORE the future resolves: a client that
        # awaited its update always reads its own write afterwards.
        if self.session is not None:
            self.session.observe(self.vid)
        if not self.future.done():
            try:
                self.future.set_result(result)
            except Exception:
                pass  # lost the set_result race to another replica

    def settle(self, durable: bool, ok: bool) -> None:
        with self._lock:
            self._left -= 1
            if ok:
                self._ok += 1
            exhausted = self._left <= 0 and self._ok == 0
        if exhausted and not durable and not self.future.done():
            try:
                self.future.set_exception(
                    RuntimeError(f"update v{self.vid} failed on every replica")
                )
            except Exception:
                pass


class _Replica:
    """One serving stack: engine + server + rollout queue + lifecycle state.

    ``gen`` increments on every crash and revive; a rollout worker exits as
    soon as its generation is superseded, so a revived replica's fresh queue
    and worker never race the old ones.
    """

    __slots__ = (
        "i",
        "engine",
        "server",
        "affinity",
        "root",
        "device",
        "mesh",
        "axis_names",
        "server_cfg",
        "warmup_bounds",
        "lock",
        "revive_lock",
        "active",
        "gen",
        "crashes",
        "restores",
        "routed",
        "rollouts",
        "thread",
    )

    def __init__(self, i, engine, server, affinity, *, root, device, mesh, axis_names, server_cfg, warmup_bounds):
        self.i = i
        self.engine = engine
        self.server = server
        self.affinity = affinity
        self.root = root
        self.device = device  # single-device engines; None for a mesh replica
        self.mesh = mesh
        self.axis_names = axis_names
        self.server_cfg = server_cfg
        self.warmup_bounds = warmup_bounds
        self.lock = threading.Lock()  # guards active/gen/crash bookkeeping
        self.revive_lock = threading.Lock()  # serializes restore attempts
        self.active = True
        self.gen = 0
        self.crashes = 0
        self.restores = 0
        self.routed = 0
        self.rollouts: "queue.SimpleQueue" = queue.SimpleQueue()
        self.thread: Optional[threading.Thread] = None

    @property
    def key(self) -> int:
        return self.i


class FleetStats(NamedTuple):
    replicas: int
    active: int
    requests: int  # client requests through the front door
    queries: int  # individual RMQs across those requests
    updates: int  # fleet rollouts submitted
    crashes: int  # replica deaths (injected or external)
    restores: int  # successful restore + rejoin cycles
    reroutes: int  # front-door resubmits after a replica failure
    stale_reroutes: int  # reroutes specifically due to StaleVersion
    affinity_hits: int  # batches routed to a matching-affinity replica
    affinity_misses: int  # matching pool existed but freshness forced elsewhere
    routed: Tuple[int, ...]  # per-replica request counts
    head_vid: int  # fleet head version id
    min_vid: int  # slowest live replica's version id
    max_lag_seen: int  # largest fleet vid spread ever observed

    def summary(self) -> str:
        return (
            f"fleet: {self.active}/{self.replicas} replicas, "
            f"{self.requests} reqs / {self.queries} RMQs, {self.updates} rollouts "
            f"(head v{self.head_vid}, min v{self.min_vid}, lag<= {self.max_lag_seen}); "
            f"routing {list(self.routed)} (affinity {self.affinity_hits} hit / "
            f"{self.affinity_misses} miss, {self.reroutes} reroutes of which "
            f"{self.stale_reroutes} stale); {self.crashes} crashes, {self.restores} restores"
        )


class RMQFleet:
    """N replica serving stacks behind a regime-routing, session-aware front
    door. Build with :meth:`build`; see the module docstring for semantics."""

    def __init__(self, replicas: List[_Replica], config: FleetConfig, *, engine: str, fault_plan=None, durable: bool = False):
        self._reps = list(replicas)
        self._cfg = config
        self.engine = engine
        self._durable = durable
        self._fault_plan = fault_plan
        self._fault = fault_plan.check if hasattr(fault_plan, "check") else fault_plan
        self._tracker = RolloutTracker(max_lag=config.max_version_lag)
        head = self._reps[0].engine
        self._dtype = head.dtype
        thr = config.threshold
        if thr is None:
            thr = head.plan.meta.get("threshold")
        self._threshold = int(thr) if thr is not None else max(1, int(round(head.n**0.5)))
        self._head_vid = head.current_vid
        self._head_n = head.n
        # Append history: (vid, n) whenever the logical length grew. Routing
        # derives a version floor from it so a query past an old length is
        # never sent to a replica that has not published the growth yet.
        self._growth: List[Tuple[int, int]] = [(self._head_vid, self._head_n)]
        self._history: Dict[int, _Rollout] = {}
        self._update_lock = threading.Lock()
        self._route_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._cursor = {"short": -1, "long": -1}
        self._requests = 0
        self._queries = 0
        self._updates = 0
        self._crashes = 0
        self._restores = 0
        self._reroutes = 0
        self._stale_reroutes = 0
        self._aff_hits = 0
        self._aff_misses = 0
        self._closed = False
        self._retryq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._retry_thread = threading.Thread(
            target=self._retry_loop, daemon=True, name="fleet-retry"
        )
        self._retry_thread.start()
        for rep in self._reps:
            self._tracker.register(rep.key, rep.engine.current_vid)
            self._start_worker(rep)

    # -- construction ---------------------------------------------------------

    @classmethod
    def build(
        cls,
        engine: str,
        x,
        *,
        config: Optional[FleetConfig] = None,
        durable_root: Optional[str] = None,
        fault_plan=None,
        device=None,
        devices=None,
        **build_kw,
    ) -> "RMQFleet":
        """Build ``config.replicas`` serving stacks over ``x``.

        A single-device engine's replicas each live on ``device`` (``None``:
        CUDA). A mesh engine's replicas carve ``devices`` (mesh positions;
        default: the visible CUDA devices) into disjoint equal groups, one
        1-D mesh per replica (at least one position per replica). With
        ``durable_root`` each replica journals under ``<root>/replica<i>``
        and crashed replicas can restore + rejoin; without it the fleet is
        in-memory and a crashed replica stays dead.
        """
        cfg = config if config is not None else FleetConfig()
        spec = registry.get(engine)
        if not spec.updatable:
            raise ValueError(f"fleet needs an updatable engine; {engine!r} is not")
        groups: List[Optional[list]] = [None] * cfg.replicas
        axis_names = None
        if spec.needs_mesh:
            if device is not None:
                raise ValueError(f"{engine!r} replicas carve devices= into meshes; device= is for one-device engines")
            devs = _positions(devices)
            if len(devs) < cfg.replicas:
                raise ValueError(
                    f"{cfg.replicas} replicas need >= {cfg.replicas} devices, have {len(devs)}"
                )
            per = len(devs) // cfg.replicas
            groups = [devs[i * per : (i + 1) * per] for i in range(cfg.replicas)]
            axis_names = ("shard",)
        else:
            if devices is not None:
                raise ValueError(f"devices= carves mesh replicas; {engine!r} runs on one device= per replica")
            device = resolve(device)
        affs = cfg.resolved_affinities()
        reps: List[_Replica] = []
        for i in range(cfg.replicas):
            mesh = make_group_mesh(groups[i]) if spec.needs_mesh else None
            where = dict(device=device, mesh=mesh, axis_names=axis_names)
            if durable_root is not None:
                root = os.path.join(durable_root, f"replica{i}")
                eng = DurableEngine.create(engine, x, root, fault=fault_plan, **where, **build_kw)
            else:
                root = None
                eng = OnlineEngine(engine, x, **where, **build_kw)
            scfg = dataclasses.replace(cfg.server, regime_affinity=affs[i])
            wb = build_mod.warmup_bounds(eng.plan)
            srv = RMQServer(
                online=eng, config=scfg, fault_plan=fault_plan, warmup_bounds=wb
            ).start()
            reps.append(
                _Replica(
                    i, eng, srv, affs[i],
                    root=root, device=device, mesh=mesh, axis_names=axis_names,
                    server_cfg=scfg, warmup_bounds=wb,
                )
            )
        return cls(reps, cfg, engine=engine, fault_plan=fault_plan, durable=durable_root is not None)

    # -- introspection --------------------------------------------------------

    @property
    def config(self) -> FleetConfig:
        return self._cfg

    @property
    def replicas(self) -> Tuple[_Replica, ...]:
        return tuple(self._reps)

    @property
    def threshold(self) -> int:
        """The short/long routing split (plan-resolved unless configured)."""
        return self._threshold

    @property
    def head_vid(self) -> int:
        """The fleet head version id (the last rollout's vid)."""
        return self._head_vid

    @property
    def head_n(self) -> int:
        """The logical array length at the fleet head."""
        return self._head_n

    @property
    def tracker(self) -> RolloutTracker:
        return self._tracker

    def session(self) -> FleetSession:
        return FleetSession()

    def warmup(self, sizes=None) -> None:
        """Warm every replica's launch shapes (affinity regime first per replica)."""
        for rep in self._reps:
            if rep.active:
                rep.server.warmup(sizes)

    def stats(self) -> FleetStats:
        with self._route_lock:
            routed = tuple(rep.routed for rep in self._reps)
            active = sum(1 for rep in self._reps if rep.active)
            hits, misses = self._aff_hits, self._aff_misses
        with self._stats_lock:
            return FleetStats(
                replicas=len(self._reps),
                active=active,
                requests=self._requests,
                queries=self._queries,
                updates=self._updates,
                crashes=self._crashes,
                restores=self._restores,
                reroutes=self._reroutes,
                stale_reroutes=self._stale_reroutes,
                affinity_hits=hits,
                affinity_misses=misses,
                routed=routed,
                head_vid=self._head_vid,
                min_vid=self._tracker.min_vid(),
                max_lag_seen=self._tracker.max_lag_seen,
            )

    def metrics(self) -> dict:
        """Fleet-level metrics document: every replica's registry snapshot
        merged under a ``replica=<i>`` label, plus front-door families
        (routing counters, rollout totals, and the RolloutTracker's
        version-lag gauges) labelled ``replica=front``. One document, so a
        scrape or a ``--metrics-interval`` dump sees the whole fleet.
        """
        snaps = {}
        for rep in self._reps:
            with rep.lock:
                srv = rep.server
            snaps[str(rep.i)] = srv.metrics.snapshot()
        front = MetricsRegistry()
        st = self.stats()
        front.counter("fleet_requests_total").inc(st.requests)
        front.counter("fleet_queries_total").inc(st.queries)
        front.counter("fleet_rollouts_total").inc(st.updates)
        front.counter("fleet_crashes_total").inc(st.crashes)
        front.counter("fleet_restores_total").inc(st.restores)
        front.counter("fleet_reroutes_total", cause="stale").inc(st.stale_reroutes)
        front.counter("fleet_reroutes_total", cause="failure").inc(
            st.reroutes - st.stale_reroutes
        )
        front.counter("fleet_routing_total", affinity="hit").inc(st.affinity_hits)
        front.counter("fleet_routing_total", affinity="miss").inc(st.affinity_misses)
        front.gauge("fleet_active_replicas").set(st.active)
        front.gauge("fleet_head_vid").set(st.head_vid)
        front.gauge("fleet_min_vid").set(st.min_vid)
        front.gauge("fleet_version_lag").set(max(0, st.head_vid - st.min_vid))
        front.gauge("fleet_max_lag_seen").set(st.max_lag_seen)
        for rep in self._reps:
            front.gauge("fleet_replica_vid", replica_id=str(rep.i)).set(
                rep.engine.current_vid if rep.active else -1
            )
        snaps["front"] = front.snapshot()
        return merge_snapshots(snaps, label="replica")

    # -- lifecycle ------------------------------------------------------------

    def __enter__(self) -> "RMQFleet":
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout: Optional[float] = None):
        with self._update_lock:
            if self._closed:
                return
            self._closed = True
        self._retryq.put(_STOP)
        for rep in self._reps:
            rep.rollouts.put(_STOP)
            # A closing fleet holds nothing back: dead keys can't wedge a
            # worker still waiting at the rollout barrier.
            self._tracker.deregister(rep.key)
        join_t = timeout if timeout is not None else 60.0
        for rep in self._reps:
            if rep.thread is not None:
                rep.thread.join(join_t)
        self._retry_thread.join(join_t)
        for rep in self._reps:
            with rep.lock:
                srv, eng = rep.server, rep.engine
                rep.active = False
            try:
                srv.close(timeout)
            except Exception:
                pass
            close_eng = getattr(eng, "close", None)
            if close_eng is not None:
                try:
                    close_eng()
                except Exception:
                    pass
        for ro in self._history.values():
            if not ro.future.done():
                try:
                    ro.future.set_exception(
                        ServerClosed("fleet closed before the rollout completed")
                    )
                except Exception:
                    pass

    # -- rollouts -------------------------------------------------------------

    def submit_update(self, deltas, *, session: Optional[FleetSession] = None) -> Future:
        """Publish one update batch to every replica (bounded-lag rollout).

        Coalesces a ``DeltaLog`` ONCE against the fleet head; every replica
        applies the identical ``DeltaBatch`` so version ids and structures
        stay aligned fleet-wide. The future resolves with the first replica's
        ``UpdateResult`` — the update is readable (and the session floor
        raised) from that moment; remaining replicas converge within
        ``max_version_lag`` versions. Use :meth:`wait_settled` for a full
        barrier.
        """
        if self._closed:
            raise ServerClosed("submit_update() on a closed fleet")
        n_ops = getattr(deltas, "n_ops", None)
        if not (len(deltas) if n_ops is None else n_ops):
            raise ValueError("submit_update() with an empty delta log")
        with self._update_lock:
            if self._closed:
                raise ServerClosed("submit_update() on a closed fleet")
            if isinstance(deltas, DeltaLog):
                batch = deltas.coalesce(self._head_n, dtype=self._dtype)
            else:
                batch = deltas
                if batch.n_old != self._head_n:
                    raise ValueError(
                        f"update batch coalesced for n={batch.n_old}, fleet head is "
                        f"n={self._head_n} (coalesce against the fleet head)"
                    )
            vid = self._head_vid + 1
            fanout = sum(1 for rep in self._reps if rep.active)
            if fanout == 0:
                raise ServerClosed("no active replicas")
            ro = _Rollout(vid, batch, fanout, session)
            self._head_vid = vid
            if batch.n_new != self._head_n:
                self._growth.append((vid, batch.n_new))
            self._head_n = batch.n_new
            self._history[vid] = ro
            for rep in self._reps:
                if rep.active:
                    rep.rollouts.put(ro)
        with self._stats_lock:
            self._updates += 1
        return ro.future

    def wait_settled(self, vid: Optional[int] = None, timeout: Optional[float] = None) -> bool:
        """Block until every live replica has published ``vid`` (default: the
        fleet head). False on timeout."""
        target = self._head_vid if vid is None else int(vid)
        return self._tracker.wait_for(
            lambda vids: (not vids) or min(vids.values()) >= target, timeout
        )

    def _start_worker(self, rep: _Replica) -> None:
        rep.thread = threading.Thread(
            target=self._rollout_worker,
            args=(rep, rep.gen),
            daemon=True,
            name=f"fleet-rollout-{rep.i}",
        )
        rep.thread.start()

    def _rollout_worker(self, rep: _Replica, gen: int) -> None:
        while True:
            item = rep.rollouts.get()
            if item is _STOP or rep.gen != gen:
                return
            ro: _Rollout = item
            tr = obs_trace.get_tracer()
            try:
                if rep.engine.current_vid >= ro.vid:
                    # A revive catch-up already applied (and acked) this
                    # batch directly; just refresh the tracker.
                    self._tracker.note(rep.key, rep.engine.current_vid)
                    ro.settle(self._durable, ok=True)
                    continue
                rospan = None
                if tr.enabled:
                    rospan = tr.start(
                        "rollout", parent=0, attrs={"replica": rep.i, "vid": ro.vid}
                    )
                try:
                    with tr.span("rollout_barrier", parent=rospan):
                        barrier_ok = self._tracker.wait_to_publish(
                            ro.vid, timeout=self._cfg.rollout_timeout_s
                        )
                    if not barrier_ok:
                        raise RuntimeError(
                            f"rollout v{ro.vid} barrier timed out on replica {rep.i}"
                        )
                    if self._fault is not None:
                        self._fault("rollout_apply")
                    with tr.span("rollout_apply", parent=rospan):
                        res = rep.server.submit_update(ro.batch).result(
                            timeout=self._cfg.rollout_timeout_s
                        )
                finally:
                    if rospan is not None:
                        tr.finish(rospan)
                self._tracker.note(rep.key, res.version)
                ro.ack(res)
                ro.settle(self._durable, ok=True)
            except BaseException as e:
                if rep.gen != gen:
                    return  # raced an external crash; the new owner cleans up
                self._crash(rep, cause=e)
                ro.settle(self._durable, ok=False)
                if self._durable and self._cfg.auto_revive and not self._closed:
                    threading.Thread(
                        target=self._revive_safe, args=(rep,), daemon=True,
                        name=f"fleet-revive-{rep.i}",
                    ).start()
                return

    # -- crash / restore ------------------------------------------------------

    def crash_replica(self, i: int, *, auto_revive: bool = False) -> None:
        """Abruptly kill replica ``i`` (chaos hook): its server is closed,
        its engine abandoned, its tracker key dropped. In-flight requests on
        it are re-routed by the front door's retry layer. Durable fleets can
        bring it back with :meth:`restore_replica` (or ``auto_revive=True``)."""
        rep = self._reps[i]
        self._crash(rep, cause=RuntimeError("externally injected crash"))
        if auto_revive and self._durable and not self._closed:
            threading.Thread(
                target=self._revive_safe, args=(rep,), daemon=True,
                name=f"fleet-revive-{rep.i}",
            ).start()

    def _crash(self, rep: _Replica, cause: BaseException) -> None:
        with rep.lock:
            if not rep.active:
                return
            rep.active = False
            rep.gen += 1
            rep.crashes += 1
            srv, eng = rep.server, rep.engine
            rep.rollouts.put(_STOP)  # unblock a worker parked on get()
        self._tracker.deregister(rep.key)
        with self._stats_lock:
            self._crashes += 1
        try:
            srv.close(timeout=10.0)
        except Exception:
            pass
        close_eng = getattr(eng, "close", None)
        if close_eng is not None:
            try:
                close_eng()
            except Exception:
                pass

    def _revive_safe(self, rep: _Replica) -> None:
        try:
            self.restore_replica(rep.i)
        except Exception:
            pass  # stays dead; restore_replica can be retried externally

    def restore_replica(self, i: int) -> None:
        """Restore crashed replica ``i`` from its durable root and rejoin it
        at the fleet head: checkpoint + journal replay brings back the vid it
        crashed at, then the missed rollout batches are replayed (and
        journaled) from the fleet history before the replica re-registers.
        No-op if the replica is already active."""
        rep = self._reps[i]
        if not self._durable:
            raise RuntimeError("restore_replica() needs a fleet built with durable_root")
        with rep.revive_lock:
            with rep.lock:
                if rep.active:
                    return
            eng = DurableEngine.restore(
                rep.root, device=rep.device, mesh=rep.mesh, axis_names=rep.axis_names,
                fault=self._fault_plan,
            )
            srv = RMQServer(
                online=eng,
                config=rep.server_cfg,
                fault_plan=self._fault_plan,
                warmup_bounds=rep.warmup_bounds,
            ).start()
            try:
                while True:
                    with self._update_lock:
                        nxt = self._history.get(eng.current_vid + 1)
                        if nxt is None:
                            if self._closed:
                                raise ServerClosed("fleet closed during restore")
                            # Fully caught up. Flip to active while holding
                            # the update lock so no rollout can slip between
                            # catch-up and registration.
                            with rep.lock:
                                rep.engine = eng
                                rep.server = srv
                                rep.gen += 1
                                rep.rollouts = queue.SimpleQueue()
                                rep.active = True
                                rep.restores += 1
                            self._tracker.register(rep.key, eng.current_vid)
                            self._start_worker(rep)
                            break
                    # Apply outside the lock: submissions proceed while the
                    # replica replays. Each apply journals to the replica's
                    # own WAL, so a crash during catch-up restores too.
                    res = eng.apply(nxt.batch)
                    nxt.ack(res)
            except BaseException:
                try:
                    srv.close(timeout=5.0)
                except Exception:
                    pass
                eng.close()
                raise
        with self._stats_lock:
            self._restores += 1

    # -- queries --------------------------------------------------------------

    def _classify(self, l: np.ndarray, r: np.ndarray) -> str:
        if l.size == 0:
            return "short"
        lens = np.asarray(r, np.int64) - np.asarray(l, np.int64) + 1
        return "short" if float(np.mean(lens <= self._threshold)) >= 0.5 else "long"

    def _needed_vid(self, hi: int) -> Optional[int]:
        """The version floor implied by the query's upper bound: the first
        vid whose logical length covers it (None = beyond the fleet head)."""
        g = self._growth
        if hi < g[0][1]:
            return -1  # the initial length covers it: any replica can answer
        for vid, n in g:
            if n > hi:
                return vid
        return None

    def submit(self, l, r, *, session: Optional[FleetSession] = None) -> Future:
        """Route one client request to a replica; Future -> ``RequestResult``.

        The batch's majority regime picks the replica pool (short-affinity
        vs long-affinity), round-robin within it. With a ``session``, only
        replicas at or past the session's observed version are eligible
        (read-your-writes); the response raises the session floor. Failed
        launches (a replica crashing underneath the request) are re-routed
        up to ``max_route_retries`` times before the client sees an error.
        """
        if self._closed:
            raise ServerClosed("submit() on a closed fleet")
        l = np.asarray(l)
        r = np.asarray(r)
        if l.shape != r.shape or l.ndim != 1:
            raise ValueError(f"l/r must be equal-shape 1-D arrays, got {l.shape} / {r.shape}")
        min_vid = session.last_vid if session is not None else -1
        if l.size:
            hi = int(np.asarray(r, np.int64).max())
            needed = self._needed_vid(hi)
            if needed is None:
                raise ValueError(f"query upper bound {hi} outside [0, {self._head_n})")
            min_vid = max(min_vid, needed)
        regime = self._classify(l, r)
        with self._stats_lock:
            self._requests += 1
            self._queries += int(l.size)
        outer: Future = Future()
        self._dispatch(l, r, regime, min_vid, session, outer, self._cfg.max_route_retries)
        return outer

    def _retry_loop(self) -> None:
        while True:
            item = self._retryq.get()
            if item is _STOP:
                return
            try:
                self._dispatch(*item)
            except BaseException as e:
                outer = item[5]
                if not outer.done():
                    outer.set_exception(e)

    def _dispatch(self, l, r, regime, min_vid, session, outer, tries) -> None:
        try:
            rep = self._pick(regime, min_vid)
            inner = rep.server.submit(l, r, min_version=min_vid if min_vid > 0 else None)
        except (ServerClosed, ServerOverloaded, StaleVersion) as e:
            if tries > 0 and not self._closed:
                with self._stats_lock:
                    self._reroutes += 1
                    if isinstance(e, StaleVersion):
                        self._stale_reroutes += 1
                self._dispatch(l, r, regime, min_vid, session, outer, tries - 1)
            elif not outer.done():
                outer.set_exception(e)
            return
        except BaseException as e:
            if not outer.done():
                outer.set_exception(e)
            return

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is None:
                res = f.result()
                if session is not None and res.version is not None:
                    session.observe(res.version)
                if not outer.done():
                    outer.set_result(res)
                return
            retryable = isinstance(exc, (ServerClosed, ServerOverloaded, StaleVersion)) or (
                isinstance(exc, EngineFailure) and exc.retryable
            )
            if retryable and tries > 0 and not self._closed:
                with self._stats_lock:
                    self._reroutes += 1
                    if isinstance(exc, StaleVersion):
                        self._stale_reroutes += 1
                # Re-dispatch on the fleet's retry thread: done-callbacks run
                # on replica worker threads, which must never block in _pick.
                self._retryq.put((l, r, regime, min_vid, session, outer, tries - 1))
            elif not outer.done():
                outer.set_exception(exc)

        inner.add_done_callback(_done)

    def _pick(self, regime: str, min_vid: int) -> _Replica:
        deadline = time.monotonic() + self._cfg.route_timeout_s
        while True:
            with self._route_lock:
                alive = [rep for rep in self._reps if rep.active]
                fresh = [rep for rep in alive if rep.engine.current_vid >= min_vid]
                if fresh:
                    pool = [rep for rep in fresh if rep.affinity == regime] or fresh
                    self._cursor[regime] += 1
                    rep = pool[self._cursor[regime] % len(pool)]
                    rep.routed += 1
                    if any(x.affinity == regime for x in alive):
                        if rep.affinity == regime:
                            self._aff_hits += 1
                        else:
                            self._aff_misses += 1
                    return rep
            if not alive:
                raise ServerClosed("no active replicas")
            left = deadline - time.monotonic()
            if left <= 0:
                raise StaleVersion(
                    f"no replica reached version {min_vid} within "
                    f"{self._cfg.route_timeout_s}s"
                )
            # Sleep on the tracker (not a spin): a publish, a register, or a
            # deregister re-evaluates. Short slices re-check replica health.
            self._tracker.wait_for(
                lambda vids: any(v >= min_vid for v in vids.values()),
                timeout=min(left, 0.25),
            )


def _positions(devices) -> list:
    """The mesh positions a mesh-engine fleet carves: ``devices`` as given,
    else the visible CUDA devices (raising when there is none: no CPU
    fallback)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh-engine fleet spans the CUDA devices by default, and CUDA is not "
            "available; pass devices= (e.g. ['cpu'] * 8)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def cli_placement(engine: str, device: str, devices, replicas: int) -> dict:
    """``RMQFleet.build``'s ``device``/``devices`` from a command line's
    ``--device`` (and ``--devices``): a mesh-engine fleet carves
    ``devices``, on ``--device cpu`` one CPU position per replica unless
    ``--devices`` names them; any other fleet runs on ``device``."""
    if not registry.get(engine).needs_mesh:
        return {"device": device, "devices": devices}
    if devices is None and torch.device(device).type == "cpu":
        devices = ["cpu"] * replicas
    return {"devices": devices}


def parse_devices(text: str) -> list:
    """``"cuda:0*8"`` or ``"cpu,cpu,cuda:1"`` -> a list of device names
    (``NAME*K`` repeats a name K times)."""
    out = []
    for item in text.split(","):
        name, _, count = item.strip().partition("*")
        out.extend([name] * (int(count) if count else 1))
    return out


# -- acceptance soak ----------------------------------------------------------


class _BlockOracle:
    """The leftmost argmin over one version's host array, exact: per-block
    minima (first occurrence) answer a range's whole blocks, numpy scans
    its two ends, and a later candidate wins only when strictly smaller.
    Equal to ``l + argmin(x[l:r+1])`` at O(bs + n/bs) per query, so a soak
    at a size users run (long ranges of millions of values) checks every
    answer in seconds."""

    BS = 1024

    def __init__(self, x: np.ndarray):
        self.x = x
        nb = x.shape[0] // self.BS
        blocks = x[: nb * self.BS].reshape(nb, self.BS)
        self.barg = blocks.argmin(axis=1)
        self.bmin = blocks[np.arange(nb), self.barg]

    def argmin(self, l: int, r: int) -> int:
        x, bs = self.x, self.BS
        bl, br = -(-l // bs), (r + 1) // bs  # the whole blocks inside [l, r]
        if bl >= br:
            return l + int(np.argmin(x[l : r + 1]))
        j = bl + int(np.argmin(self.bmin[bl:br]))
        cands = [j * bs + int(self.barg[j])]
        if l < bl * bs:  # the head scan comes first: it wins a tie
            cands.insert(0, l + int(np.argmin(x[l : bl * bs])))
        if r >= br * bs:
            cands.append(br * bs + int(np.argmin(x[br * bs : r + 1])))
        best = cands[0]
        for c in cands[1:]:
            if x[c] < x[best]:
                best = c
        return best


def _mutate(rng: np.random.Generator, cur: np.ndarray):
    """One random update batch + the expected post-update oracle array."""
    n = cur.shape[0]
    log = DeltaLog()
    new = cur.copy()
    op = rng.integers(0, 3)
    if op == 0:  # point writes
        for i in rng.integers(0, n, size=int(rng.integers(1, 5))):
            v = float(rng.standard_normal())
            log.point(int(i), v)
            new[int(i)] = np.float32(v)
    elif op == 1:  # constant range fill
        l = int(rng.integers(0, n))
        r = min(n - 1, l + int(rng.integers(0, 64)))
        v = float(rng.standard_normal())
        log.fill(l, r, v)
        new[l : r + 1] = np.float32(v)
    else:  # append
        tail = rng.standard_normal(int(rng.integers(1, 17))).astype(np.float32)
        log.append(tail)
        new = np.concatenate([new, tail])
    return log, new


class FleetSoakReport(NamedTuple):
    engine: str
    replicas: int
    seed: int
    requests: int
    queries: int
    updates: int
    crashes: int  # replica deaths (injected rollout fault + external)
    restores: int  # restore + rejoin cycles (auto-revive and explicit)
    reroutes: int
    lost_requests: int
    oracle_mismatches: int
    ryw_violations: int  # responses below the session's observed version
    max_lag_seen: int
    lag_bound: int
    settled: bool  # every live replica reached the fleet head at the end
    head_serves: bool  # post-soak head-version queries answer correctly
    elapsed_s: float
    # Per rollout, seconds from submit_update to its first publish (the
    # update is readable) and to every live replica having published it.
    first_publish_s: Tuple[float, ...] = ()
    last_publish_s: Tuple[float, ...] = ()
    # Client requests, seconds from the front door's submit to the answer.
    request_p50_s: float = 0.0
    request_p99_s: float = 0.0

    @property
    def ok(self) -> bool:
        return (
            self.oracle_mismatches == 0
            and self.lost_requests == 0
            and self.ryw_violations == 0
            and self.max_lag_seen <= self.lag_bound
            and self.settled
            and self.head_serves
            and self.crashes >= 1
            and self.restores >= 1
        )

    def summary(self) -> str:
        return (
            f"[{'OK' if self.ok else 'FAIL'}] fleet {self.engine} x{self.replicas} "
            f"seed={self.seed}: {self.requests} reqs / {self.queries} RMQs, "
            f"{self.updates} rollouts, {self.crashes} crashes -> {self.restores} "
            f"restores, {self.reroutes} reroutes; mismatches={self.oracle_mismatches} "
            f"lost={self.lost_requests} ryw_violations={self.ryw_violations}; "
            f"lag {self.max_lag_seen} <= {self.lag_bound}, settled={self.settled}, "
            f"head_serves={self.head_serves}; {self.elapsed_s:.1f}s"
        )

    def latency_summary(self) -> str:
        """Rollout and request latencies (seconds -> ms)."""

        def ms(values):
            return "/".join(f"{v * 1e3:.1f}" for v in values) or "-"

        return (
            f"rollout ms to first publish {ms(self.first_publish_s)}; to last publish "
            f"{ms(self.last_publish_s)}; requests p50 {self.request_p50_s * 1e3:.2f} ms "
            f"p99 {self.request_p99_s * 1e3:.2f} ms"
        )


def run_fleet_soak(
    *,
    engine: str = "hybrid",
    replicas: int = 3,
    n: int = 1 << 12,
    requests: int = 240,
    updates: int = 8,
    qbatch: int = 4,
    seed: int = 0,
    max_lag: int = 2,
    workers: int = 1,
    root: Optional[str] = None,
    packed: Optional[str] = None,
    device=None,
    devices=None,
    log=None,
) -> FleetSoakReport:
    """Mutate-while-serving fleet soak with a mid-rollout crash (injected at
    the ``rollout_apply`` site -> auto-revive) AND an external replica crash
    with explicit restore. Every response is verified against the host
    oracle of the version it was answered at; session queries additionally
    assert read-your-writes. Deterministic given the arguments (thread
    interleaving aside — the invariants must hold under all of them). The
    replicas live where ``RMQFleet.build``'s ``device``/``devices`` put
    them."""
    say = log if log is not None else (lambda *_: None)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    # The (replicas+1)-th rollout_apply check is the first replica to pick up
    # rollout 2: one deterministic mid-rollout death, auto-revived.
    plan = FaultPlan(seed, {"rollout_apply": FaultSpec(at=(replicas + 1,))})
    owned_root = root is None
    root = root if root is not None else tempfile.mkdtemp(prefix="rmq-fleet-")
    cfg = FleetConfig(
        replicas=replicas,
        max_version_lag=max_lag,
        auto_revive=True,
        server=ServeConfig(
            workers=workers,
            deadline_s=5e-4,
            max_retries=12,
            breaker_threshold=4,
            breaker_cooldown_s=0.02,
        ),
    )
    build_kw = {"packed": packed} if packed is not None else {}
    fleet = RMQFleet.build(
        engine, x, config=cfg, durable_root=root, fault_plan=plan,
        device=device, devices=devices, **build_kw,
    )
    sessions = [fleet.session() for _ in range(3)]
    thr = fleet.threshold

    cur = x.copy()
    expected = {fleet.head_vid: cur.copy()}
    oracles = {}  # vid -> _BlockOracle, made on first use
    mismatches = lost = ryw = nreq = nq = 0

    def oracle(vid) -> _BlockOracle:
        if vid not in oracles:
            oracles[vid] = _BlockOracle(expected[vid])
        return oracles[vid]
    pending = []  # (l, r, future, session_floor_at_submit)

    def drain():
        nonlocal mismatches, lost, ryw, nreq, nq
        for l, r, fut, floor in pending:
            nreq += 1
            nq += l.size
            try:
                res = fut.result(timeout=120)
            except Exception as e:
                lost += 1
                say(f"LOST request: {e!r}")
                continue
            if floor is not None and (res.version is None or res.version < floor):
                ryw += 1
                say(f"RYW violation: answered v{res.version} < floor v{floor}")
                continue
            if res.version not in expected:
                mismatches += l.size
                say(f"unknown version {res.version}")
                continue
            ox = oracle(res.version)
            for i in range(l.size):
                if res.idx[i] != ox.argmin(int(l[i]), int(r[i])):
                    mismatches += 1
        pending.clear()

    first_s, last_s, req_s, settle_waits = [], {}, [], []

    def settle_wait(vid: int, t_submit: float) -> None:
        # Every live replica has published vid (a dead one no longer counts).
        fleet.tracker.wait_for(lambda vids: not vids or min(vids.values()) >= vid, timeout=120)
        last_s[vid] = time.perf_counter() - t_submit

    update_every = max(1, requests // max(updates, 1))
    crash_at = requests // 2
    restore_at = (3 * requests) // 4
    victim = None
    for step in range(requests):
        if updates and step and step % update_every == 0:
            sess = sessions[(step // update_every) % len(sessions)]
            dlog, new = _mutate(rng, cur)
            t_upd = time.perf_counter()
            res = fleet.submit_update(dlog, session=sess).result(timeout=120)
            first_s.append(time.perf_counter() - t_upd)
            waiter = threading.Thread(target=settle_wait, args=(res.version, t_upd), daemon=True)
            waiter.start()
            settle_waits.append(waiter)
            if sess.last_vid < res.version:
                ryw += 1
                say(f"session floor {sess.last_vid} below acked v{res.version}")
            cur = new
            expected[res.version] = cur.copy()
        if step == crash_at:
            drain()
            alive = [rep.i for rep in fleet.replicas if rep.active]
            victim = alive[-1]
            say(f"externally crashing replica {victim}")
            fleet.crash_replica(victim)
        if step == restore_at and victim is not None:
            say(f"restoring replica {victim}")
            fleet.restore_replica(victim)
        nmax = cur.shape[0]
        short = step % 2 == 0
        span = max(1, thr // 2) if short else max(thr * 4, nmax // 4)
        l = rng.integers(0, nmax, qbatch).astype(np.int32)
        r = np.minimum(nmax - 1, l + rng.integers(0, span, qbatch)).astype(np.int32)
        sess = sessions[step % len(sessions)] if step % 3 == 0 else None
        floor = sess.last_vid if sess is not None and sess.last_vid >= 0 else None
        fut = fleet.submit(l, r, session=sess)
        fut.add_done_callback(lambda f, t_req=time.perf_counter(): req_s.append(time.perf_counter() - t_req))
        pending.append((l, r, fut, floor))
    drain()
    for waiter in settle_waits:
        waiter.join(timeout=120)

    settled = fleet.wait_settled(timeout=120)
    head = fleet.head_vid
    ox = expected[head]
    head_serves = True
    l = rng.integers(0, ox.shape[0], 8).astype(np.int32)
    r = np.minimum(ox.shape[0] - 1, l + rng.integers(0, 256, 8)).astype(np.int32)
    ox_q = oracle(head)
    sess = fleet.session()
    sess.observe(head)
    try:
        res = fleet.submit(l, r, session=sess).result(timeout=120)
        if res.version != head:
            head_serves = False
        for i in range(8):
            if res.idx[i] != ox_q.argmin(int(l[i]), int(r[i])):
                head_serves = False
    except Exception as e:
        say(f"head-version probe failed: {e!r}")
        head_serves = False

    st = fleet.stats()
    fleet.close()
    if owned_root:
        shutil.rmtree(root, ignore_errors=True)
    return FleetSoakReport(
        engine=engine,
        replicas=replicas,
        seed=seed,
        requests=nreq,
        queries=nq,
        updates=st.updates,
        crashes=st.crashes,
        restores=st.restores,
        reroutes=st.reroutes,
        lost_requests=lost,
        oracle_mismatches=mismatches,
        ryw_violations=ryw,
        max_lag_seen=st.max_lag_seen,
        lag_bound=max_lag,
        settled=settled,
        head_serves=head_serves,
        elapsed_s=time.perf_counter() - t0,
        first_publish_s=tuple(first_s),
        last_publish_s=tuple(last_s[v] for v in sorted(last_s)),
        request_p50_s=float(np.percentile(req_s, 50)) if req_s else 0.0,
        request_p99_s=float(np.percentile(req_s, 99)) if req_s else 0.0,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="replica-fleet soak: regime routing, bounded-lag rollouts, crash+rejoin")
    p.add_argument("--engine", default="hybrid", choices=sorted(online_names()))
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--n", type=int, default=1 << 12)
    p.add_argument("--requests", type=int, default=240)
    p.add_argument("--updates", type=int, default=8)
    p.add_argument("--qbatch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-lag", type=int, default=2)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument(
        "--packed",
        nargs="?",
        const="auto",
        choices=["auto", "packed32", "packed64", "quantized"],
        default=None,
        help="serve fused (value, index) word structures (engines declaring a "
        "'packed' build kwarg; bare --packed = 'auto')",
    )
    p.add_argument("--device", default="cuda", help="torch device the replicas run on (cuda | cpu)")
    p.add_argument(
        "--devices",
        default=None,
        help="mesh positions a mesh-engine fleet carves into replica groups, "
        "comma-separated, NAME*K repeats (e.g. 'cuda:0*8'; default: the "
        "visible cards; on --device cpu one CPU position per replica)",
    )
    p.add_argument("--root", default=None, help="durability root (default: temp dir)")
    p.add_argument("--json", default=None, help="write the report as JSON here")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    if args.packed is not None and "packed" not in registry.get(args.engine).build_kwargs:
        p.error(
            f"--packed requires an engine with a 'packed' build kwarg; "
            f"{args.engine} declares {sorted(registry.get(args.engine).build_kwargs) or '()'}"
        )
    devices = parse_devices(args.devices) if args.devices is not None else None
    where = cli_placement(args.engine, args.device, devices, args.replicas)
    if registry.get(args.engine).needs_mesh and not args.quiet:
        pos = _positions(where["devices"])
        print(f"{len(pos)} positions, {len(pos) // args.replicas} per replica group")

    report = run_fleet_soak(
        engine=args.engine,
        replicas=args.replicas,
        n=args.n,
        requests=args.requests,
        updates=args.updates,
        qbatch=args.qbatch,
        seed=args.seed,
        max_lag=args.max_lag,
        workers=args.workers,
        root=args.root,
        packed=args.packed,
        **where,
        log=None if args.quiet else print,
    )
    print(report.summary())
    print(report.latency_summary())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report._asdict(), f, indent=2, default=str)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
