"""Async RMQ server: request queue -> deadline micro-batcher -> engine pool.

``RMQServer`` accepts variable-size query batches from concurrent clients
and coalesces them into power-of-two padded engine launches:

    submit(l, r) ─► admission control (bounded in-flight requests)
        └─► request queue ─► batcher thread
              │   flush when the coalesced batch reaches ``max_batch``
              │   queries OR the oldest pending request ages past
              │   ``deadline_s`` — latency is bounded by the deadline even
              │   at low offered load
              └─► microbatch queue ─► engine-pool worker threads
                    └─► scatter-back, per-request futures + latency stamps
    submit_update(deltas) ─► batcher barrier (flush what's pending first)
        └─► update queue ─► single updater thread
              └─► OnlineEngine.apply: patch + MVCC publish

Admission control bounds *in-flight* requests (queued + batching +
executing): past ``max_pending``, ``submit`` raises ``ServerOverloaded``.
Per-request latency decomposes as queue (submit -> flush) plus service
(flush -> done); ``stats()`` aggregates p50/p99 and sustained throughput.

The engine is any ``(l, r) -> (idx, val)`` callable — typically a registry
``EngineSpec.query`` closed over its built state (``launch.serve`` wires
exactly that). Its results may be CUDA tensors: ``scatter_back`` brings
them to the host, once per launch. Workers are supervised (a crashed
worker restarts with backoff), a failed launch retries or fails only its
own requests, and a circuit breaker routes launches to an explicit
``fallback`` while the primary keeps failing.

**Mutation under live traffic**: constructed over a ``repro_torch.update``
``OnlineEngine`` instead of a bare callable, the server also accepts
``submit_update(DeltaLog)``. Updates interleave with query launches: the
batcher flushes pending queries first (so requests submitted before an
update are answered against the pre-update version), each flushed
microbatch **pins** the then-current MVCC version and is answered entirely
against that snapshot, and a single updater thread applies updates in
submission order (publish order = consistency order). ``stats()`` adds
update-latency percentiles and version lag (how many versions were
published while a query batch was in flight). The breaker of an online
server routes to a ``fault.DegradedFallback`` built from the pinned
version's host array.

**Adaptive deadline** (``ServeConfig.adaptive_deadline``): the batcher
shrinks its coalescing deadline while launches fill up and grows it back
toward ``deadline_max_s`` when flushes are deadline-triggered and
near-empty. The trajectory is recorded per flush in ``ServeStats``.

**Crash recovery**: ``restore=DIR`` restores a ``fault.DurableEngine``
from its root (latest checkpoint + journal-suffix replay) onto ``device``
and serves it like ``online=``; a ``DurableEngine`` passed as ``online=``
serves the same way.

**Fleet hooks** (``serve.fleet``): ``submit(min_version=V)`` raises
``StaleVersion`` on a server that has not yet published V (the
read-your-writes backstop), and ``ServeConfig.regime_affinity`` names the
query regime a replica is hot for; its warmup runs that regime first.

Port of ``repro/serve/server.py``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core import hybrid as _hybrid
from repro_torch.fault.inject import InjectedFault
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import get_tracer

from .batcher import MicroBatch, bucket, coalesce, scatter_back

__all__ = [
    "DeadlineExceeded",
    "EngineFailure",
    "RMQServer",
    "RequestResult",
    "RequestTiming",
    "ServeConfig",
    "ServeStats",
    "ServerClosed",
    "ServerOverloaded",
    "StaleVersion",
]

_INT32_MAX = np.iinfo(np.int32).max
_STOP = object()


class ServerClosed(RuntimeError):
    """submit() after close() — or a request still unresolved when the
    server shut down (close() fails every leftover future with this rather
    than leaving a client hanging forever)."""


class ServerOverloaded(RuntimeError):
    """Admission control rejected the request: too many in flight."""


class EngineFailure(RuntimeError):
    """A query launch failed after exhausting its retry budget.

    Typed and (by default) retryable: the underlying failure is a worker
    crash, an injected fault, or an engine exception — resubmitting the
    request may well succeed (the supervisor restarts crashed workers, the
    breaker may have routed to the fallback meanwhile). ``cause`` holds the
    original exception.
    """

    def __init__(self, msg: str, *, cause: Optional[BaseException] = None, retryable: bool = True):
        super().__init__(msg)
        self.cause = cause
        self.retryable = retryable


class DeadlineExceeded(RuntimeError):
    """The request's ``request_timeout_s`` deadline passed before an engine
    answered it (in queue, or across too many retries)."""


class StaleVersion(RuntimeError):
    """``submit(min_version=V)`` on a server still serving a version < V.

    The read-your-writes signal: a fleet front door catches this and routes
    the request to (or waits for) a replica that has published V.
    """


@dataclass(frozen=True)
class ServeConfig:
    deadline_s: float = 2e-3  # max coalescing wait for the oldest request
    max_batch: int = 4096  # flush once the coalesced batch reaches this
    max_pending: int = 4096  # in-flight request bound (admission control)
    workers: int = 1  # engine-pool threads
    n: Optional[int] = None  # if set, submit validates r < n
    val_dtype: object = np.float32  # engine value dtype (empty-request results)
    # Adaptive deadline: start at deadline_s, halve toward deadline_min_s on
    # size-triggered flushes (sustained load), grow toward deadline_max_s on
    # near-empty deadline flushes (idle). None bounds derive from deadline_s.
    adaptive_deadline: bool = False
    deadline_min_s: Optional[float] = None  # default: deadline_s / 8
    deadline_max_s: Optional[float] = None  # default: deadline_s * 4
    # Crash-safe serving (supervised workers, retry, circuit breaker).
    request_timeout_s: Optional[float] = None  # per-request deadline (None = no limit)
    max_retries: int = 0  # automatic resubmits after a failed launch
    breaker_threshold: int = 0  # consecutive failures to trip (0 = disabled)
    breaker_cooldown_s: float = 0.05  # open time before a half-open health probe
    worker_backoff_s: float = 0.01  # first restart delay for a crashed worker
    worker_backoff_max_s: float = 1.0  # exponential backoff cap
    # Fleet routing hint: which query regime this server's pool is hot for
    # ("short" = blocked path, "long" = sparse-table path, None = no
    # affinity). Warmup runs the hot regime first, and the fleet front door
    # routes matching batches here.
    regime_affinity: Optional[str] = None

    def __post_init__(self):
        if self.deadline_s < 0 or self.max_batch < 1 or self.max_pending < 1 or self.workers < 1:
            raise ValueError(f"invalid ServeConfig: {self}")
        if self.adaptive_deadline and self.deadline_s <= 0:
            raise ValueError("adaptive_deadline requires deadline_s > 0")
        lo, hi = self.deadline_bounds()
        if not 0 <= lo <= self.deadline_s <= hi:
            raise ValueError(
                f"deadline bounds must satisfy 0 <= min <= deadline_s <= max: {self}"
            )
        if (
            self.max_retries < 0
            or self.breaker_threshold < 0
            or self.breaker_cooldown_s < 0
            or self.worker_backoff_s <= 0
            or self.worker_backoff_max_s < self.worker_backoff_s
        ):
            raise ValueError(f"invalid ServeConfig: {self}")
        if self.request_timeout_s is not None and self.request_timeout_s <= 0:
            raise ValueError(f"request_timeout_s must be > 0 or None: {self}")
        if self.regime_affinity not in (None, "short", "long"):
            raise ValueError(
                f"regime_affinity must be None, 'short', or 'long': {self.regime_affinity!r}"
            )

    def deadline_bounds(self) -> Tuple[float, float]:
        """(min, max) the adaptive deadline moves within."""
        lo = self.deadline_min_s if self.deadline_min_s is not None else self.deadline_s / 8
        hi = self.deadline_max_s if self.deadline_max_s is not None else self.deadline_s * 4
        return lo, hi


class RequestTiming(NamedTuple):
    queue_s: float  # submit -> batch flush (coalescing wait)
    service_s: float  # flush -> engine done
    total_s: float


class RequestResult(NamedTuple):
    idx: np.ndarray  # (B,) int32 leftmost argmin per query
    val: np.ndarray  # (B,) corresponding values
    timing: RequestTiming
    version: Optional[int] = None  # MVCC version answered against (online only)


class _Request:
    __slots__ = ("l", "r", "future", "t_submit", "t_flush", "retries", "span", "qspan")

    def __init__(self, l, r, t_submit):
        self.l = l
        self.r = r
        self.future: Future = Future()
        self.t_submit = t_submit
        self.t_flush = 0.0
        self.retries = 0  # failed launches this request has survived so far
        self.span = None  # "request" root span (tracing enabled only)
        self.qspan = None  # open "queue" span: submit/requeue -> flush


class _UpdateReq:
    __slots__ = ("deltas", "future", "t_submit")

    def __init__(self, deltas, t_submit):
        self.deltas = deltas
        self.future: Future = Future()
        self.t_submit = t_submit


class ServeStats(NamedTuple):
    served_requests: int
    served_queries: int
    rejected_requests: int
    n_batches: int
    mean_batch_requests: float
    mean_batch_queries: float
    padded_sizes: Tuple[int, ...]  # distinct launch shapes
    p50_queue_s: float
    p99_queue_s: float
    p50_total_s: float
    p99_total_s: float
    throughput_qps: float  # served queries / (first submit -> last done)
    # Per-launch regime split (short, long) sub-batch sizes, as reported by
    # the range-adaptive dispatcher — empty for single-path engines. The
    # measurement regime-aware routing (server-level split, per-engine
    # pools) will act on.
    regime_splits: Tuple[Tuple[int, int], ...] = ()
    # Effective batcher deadline after each flush (adaptive mode only).
    deadline_trajectory: Tuple[float, ...] = ()
    # Online-update accounting (servers built over an OnlineEngine).
    applied_updates: int = 0
    p50_update_s: float = 0.0  # submit_update -> published
    p99_update_s: float = 0.0
    # Per-query-launch version lag: versions published between a batch's
    # pin and its completion (0 = answered against the newest version).
    version_lags: Tuple[int, ...] = ()
    # Crash-safety accounting (supervision / retry / breaker / fallback).
    degraded_launches: int = 0  # launches served by the degraded fallback
    worker_restarts: int = 0  # crashed workers the supervisor restarted
    retried_requests: int = 0  # failed-launch requests resubmitted to the batcher
    expired_requests: int = 0  # requests failed on their request_timeout_s deadline
    failed_requests: int = 0  # requests failed with EngineFailure (retries exhausted)
    breaker_trips: int = 0  # closed -> open transitions of the circuit breaker

    @property
    def short_queries(self) -> int:
        return sum(s for s, _ in self.regime_splits)

    @property
    def long_queries(self) -> int:
        return sum(g for _, g in self.regime_splits)

    @property
    def mixed_batches(self) -> int:
        """Launches the dispatcher actually split (both regimes non-empty)."""
        return sum(1 for s, g in self.regime_splits if s and g)

    @property
    def version_lag_max(self) -> int:
        return max(self.version_lags) if self.version_lags else 0

    @property
    def version_lag_mean(self) -> float:
        return float(np.mean(self.version_lags)) if self.version_lags else 0.0

    def summary(self) -> str:
        out = (
            f"{self.served_requests} reqs / {self.served_queries} RMQs in "
            f"{self.n_batches} microbatches (mean {self.mean_batch_requests:.1f} "
            f"reqs, {self.mean_batch_queries:.1f} RMQs; padded shapes "
            f"{list(self.padded_sizes)}); latency p50 {self.p50_total_s*1e3:.2f} ms "
            f"p99 {self.p99_total_s*1e3:.2f} ms (queue p50 "
            f"{self.p50_queue_s*1e3:.2f} ms); {self.throughput_qps:,.0f} RMQ/s; "
            f"rejected {self.rejected_requests}"
        )
        if self.regime_splits:
            out += (
                f"; regime split {self.short_queries} short / "
                f"{self.long_queries} long RMQs, {self.mixed_batches}/"
                f"{len(self.regime_splits)} launches mixed"
            )
        if len(self.deadline_trajectory) >= 2:
            out += (
                f"; adaptive deadline {self.deadline_trajectory[0]*1e3:.2f} -> "
                f"{self.deadline_trajectory[-1]*1e3:.2f} ms"
            )
        elif self.deadline_trajectory:
            # One adjusted flush: "X -> X ms" would misread as a flat
            # trajectory, so report the single point and the flush count.
            out += (
                f"; adaptive deadline {self.deadline_trajectory[0]*1e3:.2f} ms "
                f"(1 adjusted flush)"
            )
        if self.applied_updates:
            out += (
                f"; {self.applied_updates} updates (p50 "
                f"{self.p50_update_s*1e3:.2f} ms, p99 {self.p99_update_s*1e3:.2f} ms), "
                f"version lag max {self.version_lag_max} "
                f"mean {self.version_lag_mean:.2f}"
            )
        if (
            self.worker_restarts
            or self.retried_requests
            or self.degraded_launches
            or self.expired_requests
            or self.failed_requests
            or self.breaker_trips
        ):
            out += (
                f"; faults: {self.worker_restarts} worker restarts, "
                f"{self.retried_requests} retried / {self.expired_requests} expired / "
                f"{self.failed_requests} failed reqs, breaker tripped "
                f"{self.breaker_trips}x ({self.degraded_launches} degraded launches)"
            )
        return out


class RMQServer:
    """Deadline micro-batching server over one built RMQ engine, or over an
    ``OnlineEngine`` (``online=``) whose versions each launch pins."""

    def __init__(
        self,
        query_fn: Optional[Callable] = None,
        config: Optional[ServeConfig] = None,
        *,
        online=None,  # repro_torch.update.OnlineEngine or fault.DurableEngine
        restore: Optional[str] = None,  # DurableEngine root to restore from
        device=None,  # where a restore puts the engine (None: CUDA)
        warmup_bounds: Optional[Callable] = None,
        fault_plan=None,  # fault.FaultPlan (or check callable): worker_query site
        fallback: Optional[Callable] = None,  # degraded (l, r) -> (idx, val)
        tracer=None,  # obs.Tracer (None = the process-global tracer)
        metrics=None,  # obs.MetricsRegistry (None = a fresh private registry)
        trace_attrs=None,  # static attrs stamped on every launch span
        **overrides,
    ):
        if sum(x is not None for x in (query_fn, online, restore)) != 1:
            raise ValueError("pass exactly one of query_fn, online, or restore")
        if restore is not None:
            # Crash recovery at construction: latest checkpoint + journal
            # suffix replay -> bit-identical to the never-crashed engine.
            from repro_torch.fault.durable import DurableEngine

            online = DurableEngine.restore(restore, device=device, fault=fault_plan)
        self._online = online
        if online is not None:
            # Warmup / direct path: answer against the then-current version.
            def query_fn(l, r):
                ver = online.pin()
                try:
                    return online.query(ver.state, l, r)
                finally:
                    online.release(ver.vid)

        self._query_fn = query_fn
        self._warmup_bounds = warmup_bounds  # (size) -> [(l, r), ...] per regime
        self._cfg = config if config is not None else ServeConfig(**overrides)
        self._inq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._mbq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._updq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._inflight = 0
        self._closed = False
        self._started = False
        self._threads: List[threading.Thread] = []
        # Supervision + breaker state. _live tracks every admitted request /
        # update whose future is unresolved, so close() can fail leftovers
        # instead of leaving clients hanging.
        self._live: Set[object] = set()
        self._deaths: "queue.SimpleQueue" = queue.SimpleQueue()  # crashed worker slots
        self._fault = fault_plan.check if hasattr(fault_plan, "check") else fault_plan
        self._fallback_fn = fallback
        self._degraded = None  # lazy fault.DegradedFallback (online servers)
        if self._cfg.breaker_threshold > 0 and online is None and fallback is None:
            raise ValueError(
                "breaker_threshold > 0 needs a degraded path: an online engine "
                "(version x_host fallback) or an explicit fallback callable"
            )
        self._brk_fails = 0  # consecutive primary-launch failures
        self._brk_open = False
        self._brk_opened_t = 0.0
        self._brk_probing = False
        # Observability. The tracer defaults to the process-global one
        # (disabled unless `launch/serve.py --trace` or a test installed an
        # enabled tracer); the registry is private per server unless shared.
        # ServeStats is rendered FROM these instruments in stats(), so the
        # registry and the NamedTuple reconcile by construction.
        self._tracer = tracer if tracer is not None else get_tracer()
        self.metrics: MetricsRegistry = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        ta = dict(trace_attrs) if trace_attrs else {}
        ta.setdefault(
            "engine", getattr(online, "name", None) or getattr(query_fn, "__name__", None) or "engine"
        )
        self._trace_attrs = ta
        self._m_out = {  # request terminal outcomes
            k: m.counter("serve_requests_total", outcome=k)
            for k in ("served", "rejected", "retried", "expired", "failed")
        }
        self._m_queries = m.counter("serve_queries_total")
        self._m_batches = m.counter("serve_batches_total")
        self._m_launches = {
            pool: m.counter("serve_launches_total", pool=pool) for pool in ("primary", "degraded")
        }
        self._m_regime = {
            reg: m.counter("serve_regime_queries_total", regime=reg) for reg in ("short", "long")
        }
        self._m_updates = {
            k: m.counter("serve_updates_total", outcome=k) for k in ("applied", "failed")
        }
        self._m_restarts = m.counter("serve_worker_restarts_total")
        self._m_trips = m.counter("serve_breaker_trips_total")
        self._h_queue = m.histogram("serve_queue_wait_s")
        self._h_service = m.histogram("serve_service_s")
        self._h_total = m.histogram("serve_total_s")
        self._h_update = m.histogram("serve_update_s")
        self._h_launch = {
            pool: m.histogram("serve_launch_s", pool=pool) for pool in ("primary", "degraded")
        }
        self._g_inflight = m.gauge("serve_inflight")
        self._g_deadline = m.gauge("serve_deadline_eff_s")
        self._g_vlag = m.gauge("serve_version_lag")
        # Structural accumulators (under _lock) — sequences/sets the scalar
        # instruments can't represent; ServeStats carries them verbatim.
        self._splits: List[Tuple[int, int]] = []  # per-launch (short, long)
        self._padded: Set[int] = set()
        self._deadlines: List[float] = []  # effective deadline per flush
        self._lags: List[int] = []  # per-launch version lag
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None

    @property
    def config(self) -> ServeConfig:
        return self._cfg

    @property
    def online(self):
        """The OnlineEngine/DurableEngine this server serves (None for bare
        query_fn servers). Fleet routing reads ``online.current_vid`` here."""
        return self._online

    @property
    def affinity(self) -> Optional[str]:
        """The regime this server's pool is hot for (``ServeConfig``)."""
        return self._cfg.regime_affinity

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "RMQServer":
        if self._started:
            return self
        self._started = True
        self._threads = [threading.Thread(target=self._batch_loop, daemon=True, name="rmq-batcher")]
        for i in range(self._cfg.workers):
            self._threads.append(
                threading.Thread(
                    target=self._worker_main, args=(i,), daemon=True, name=f"rmq-worker-{i}"
                )
            )
        self._threads.append(
            threading.Thread(target=self._supervisor_loop, daemon=True, name="rmq-supervisor")
        )
        if self._online is not None:
            # ONE updater: publish order == submission order == version order.
            self._threads.append(
                threading.Thread(target=self._update_loop, daemon=True, name="rmq-updater")
            )
        for t in self._threads:
            t.start()
        return self

    def __enter__(self) -> "RMQServer":
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout: Optional[float] = None):
        """Stop accepting, drain everything already admitted, join threads.

        With a ``timeout``, each join waits at most that long; any request or
        update future still unresolved afterwards is failed with
        ``ServerClosed`` — a client blocked on ``future.result()`` always
        unblocks.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._started:
                self._inq.put(_STOP)  # under _lock: serialized against submit
        self._deaths.put(_STOP)  # supervisor exits; no restarts after close
        for t in self._threads:
            t.join(timeout)
        with self._lock:
            leftovers = [q for q in self._live if not q.future.done()]
            self._live.clear()
            self._inflight = 0
        for q in leftovers:
            if isinstance(q, _Request):
                self._trace_resolve(q, "closed")
            self._fail_future(q, ServerClosed("server closed before the request completed"))

    def warmup(self, sizes: Optional[Sequence[int]] = None):
        """Run every padded launch shape once before traffic hits.

        By default this runs the engine once per power-of-two bucket up to
        ``max_batch`` — exactly the shapes the batcher can emit — so kernel
        builds and first-launch costs stay out of client latency. The probe
        batches come from ``warmup_bounds`` when the server was built from a
        BuildPlan (``core.build.warmup_bounds``): one batch per query regime
        the plan's threshold can dispatch to. Without a plan, when
        ``config.n`` is known each shape runs on all-(0, 0) and all-(0, n-1)
        batches, so a range-adaptive engine warms both regimes. A server
        whose ``regime_affinity`` is ``"long"`` runs the long regime's probe
        of each size first.
        """
        if sizes is None:
            top = bucket(self._cfg.max_batch)
            sizes, s = [], 1
            while s <= top:
                sizes.append(s)
                s *= 2
        n = self._cfg.n
        for s in sizes:
            if self._warmup_bounds is not None:
                probes = list(self._warmup_bounds(s))
                if self._cfg.regime_affinity == "long":
                    # Hot-pool affinity: the affinity regime first (probes
                    # come short-regime first), so a replica's first real
                    # batch finds it warm even if warmup is cut short.
                    probes.reverse()
                for l, r in probes:
                    self._query_fn(l, r)
                continue
            zeros = np.zeros(s, np.int32)
            self._query_fn(zeros, zeros)
            if n is not None and n > 1:
                self._query_fn(zeros, np.full(s, n - 1, np.int32))

    # -- client API ---------------------------------------------------------

    def submit(self, l, r, *, min_version: Optional[int] = None) -> Future:
        """Enqueue one client request of (l, r) query bounds -> Future.

        The future resolves to a ``RequestResult`` whose idx/val (numpy, on
        the host) line up elementwise with the submitted bounds. Raises
        ``ServerOverloaded`` when admission control rejects (backpressure),
        ``ServerClosed`` after ``close()``, and ``ValueError``/``TypeError``
        on malformed bounds.

        ``min_version`` (online servers) is a session's floor: if this
        server's engine has not yet published version ``min_version``, raise
        ``StaleVersion`` instead of enqueueing. Version ids are monotone and
        batches pin the version current at flush time, so passing the check
        here guarantees an answer at a version >= ``min_version``, across
        automatic retries too.
        """
        if self._closed:
            raise ServerClosed("submit() on a closed server")
        if not self._started:
            raise ServerClosed("submit() before start()")
        if min_version is not None:
            if self._online is None:
                raise ValueError("min_version needs a server with an OnlineEngine")
            cur = self._online.current_vid
            if cur < min_version:
                raise StaleVersion(f"server at version {cur}, request requires >= {min_version}")
        l = np.asarray(l)
        r = np.asarray(r)
        if l.shape != r.shape or l.ndim != 1:
            raise ValueError(f"l/r must be equal-shape 1-D arrays, got {l.shape} / {r.shape}")
        if not (np.issubdtype(l.dtype, np.integer) and np.issubdtype(r.dtype, np.integer)):
            raise TypeError(f"query bounds must be integer arrays, got {l.dtype} / {r.dtype}")
        if l.size == 0:
            fut: Future = Future()
            fut.set_result(
                RequestResult(
                    np.zeros(0, np.int32),
                    np.zeros(0, np.dtype(self._cfg.val_dtype)),
                    RequestTiming(0.0, 0.0, 0.0),
                )
            )
            return fut
        if l.size > self._cfg.max_batch:
            raise ValueError(
                f"request of {l.size} queries exceeds max_batch={self._cfg.max_batch}; split it"
            )
        lo, hi = int(l.min()), int(np.asarray(r, np.int64).max())
        if lo < 0 or np.any(r < l):
            raise ValueError("query bounds must satisfy 0 <= l <= r")
        # Online servers validate against the CURRENT logical length: if a
        # client saw the post-append length, that append already published,
        # so any version pinned later can answer it.
        n_bound = self._online.n if self._online is not None else self._cfg.n
        if hi > _INT32_MAX or (n_bound is not None and hi >= n_bound):
            bound = n_bound if n_bound is not None else _INT32_MAX + 1
            raise ValueError(f"query upper bound {hi} outside [0, {bound})")

        now = time.perf_counter()
        req = _Request(l.astype(np.int32), r.astype(np.int32), now)
        tr = self._tracer
        with self._lock:
            if self._closed:
                raise ServerClosed("submit() on a closed server")
            if self._inflight >= self._cfg.max_pending:
                self._m_out["rejected"].inc()
                raise ServerOverloaded(
                    f"{self._inflight} requests in flight (max_pending={self._cfg.max_pending})"
                )
            self._inflight += 1
            self._g_inflight.set(self._inflight)
            self._live.add(req)
            if self._t_first_submit is None:
                self._t_first_submit = now
            if tr.enabled:
                # Request lifecycle root + its first children. parent=0 forces
                # a root: the client thread's ambient span (if any) is not
                # part of this request's chain.
                req.span = tr.start("request", parent=0, attrs={"queries": int(l.size)})
                tr.instant("admission", parent=req.span, attrs={"inflight": self._inflight})
                req.qspan = tr.start("queue", parent=req.span)
            self._inq.put(req)  # under _lock: never lands after close()'s _STOP
        return req.future

    def submit_update(self, deltas) -> Future:
        """Enqueue one update batch (a ``repro_torch.update`` DeltaLog/DeltaBatch).

        The future resolves to the ``UpdateResult`` of the published version.
        Updates are barriers in the batcher (queries submitted before an
        update are flushed — and version-pinned — first) and are applied in
        submission order by the single updater thread. Shares admission
        control with queries: a stalled updater backpressures too.
        """
        if self._online is None:
            raise ValueError("submit_update() on a server without an OnlineEngine")
        if self._closed:
            raise ServerClosed("submit_update() on a closed server")
        if not self._started:
            raise ServerClosed("submit_update() before start()")
        # Emptiness: DeltaBatch is a NamedTuple, so len() would count its
        # *fields* (always truthy) — use the op count both types expose.
        n_ops = getattr(deltas, "n_ops", None)
        if not (len(deltas) if n_ops is None else n_ops):
            raise ValueError("submit_update() with an empty delta log")
        req = _UpdateReq(deltas, time.perf_counter())
        with self._lock:
            if self._closed:
                raise ServerClosed("submit_update() on a closed server")
            if self._inflight >= self._cfg.max_pending:
                self._m_out["rejected"].inc()
                raise ServerOverloaded(
                    f"{self._inflight} requests in flight (max_pending={self._cfg.max_pending})"
                )
            self._inflight += 1
            self._g_inflight.set(self._inflight)
            self._live.add(req)
            self._inq.put(req)
        return req.future

    # -- internals ----------------------------------------------------------

    def _batch_loop(self):
        cfg = self._cfg
        pending: List[_Request] = []
        pend_q = 0
        eff = cfg.deadline_s  # effective deadline (moves only when adaptive)
        dmin, dmax = cfg.deadline_bounds()

        def flush(reason: str):
            nonlocal pending, pend_q, eff
            tr = self._tracer
            if cfg.request_timeout_s is not None:
                # Requests past their deadline fail here instead of occupying
                # a launch: an expired client has stopped waiting already.
                now = time.perf_counter()
                expired = [q for q in pending if now - q.t_submit > cfg.request_timeout_s]
                if expired:
                    pending = [q for q in pending if now - q.t_submit <= cfg.request_timeout_s]
                    pend_q = sum(q.l.size for q in pending)
                    with self._lock:
                        self._inflight -= len(expired)
                        self._g_inflight.set(self._inflight)
                        for q in expired:
                            self._live.discard(q)
                    self._m_out["expired"].inc(len(expired))
                    for q in expired:
                        self._trace_resolve(q, "expired")
                        self._fail_future(
                            q,
                            DeadlineExceeded(
                                f"request expired after {now - q.t_submit:.3f}s "
                                f"(request_timeout_s={cfg.request_timeout_s})"
                            ),
                        )
                    if not pending:
                        return
            # The flush span is this batch's root: coalesce/launch/scatter
            # hang off it, and every member request links to it via its
            # "batch" attr. It travels to the worker and finishes there.
            fs = None
            if tr.enabled:
                fs = tr.start("flush", parent=0, attrs={"reason": reason})
                with tr.span("coalesce", parent=fs):
                    mb = coalesce([q.l for q in pending], [q.r for q in pending])
            else:
                mb = coalesce([q.l for q in pending], [q.r for q in pending])
            t = time.perf_counter()
            for q in pending:
                q.t_flush = t
            if fs is not None:
                fs.attrs["n_requests"] = len(pending)
                fs.attrs["n_queries"] = int(mb.n_queries)
                fs.attrs["padded"] = mb.padded_size
                fs.attrs["fill"] = round(mb.fill_fraction, 4)
                for q in pending:
                    if q.span is not None:
                        q.span.set_attr("batch", fs.span_id)
                    if q.qspan is not None:
                        tr.finish(q.qspan)
                        q.qspan = None
            # Snapshot isolation: the whole launch is answered against the
            # version current at flush time, however long it sits in the
            # microbatch queue and whatever publishes meanwhile.
            ver = self._online.pin() if self._online is not None else None
            if fs is not None and ver is not None:
                fs.attrs["version"] = ver.vid
            self._mbq.put((mb, pending, ver, fs))
            if cfg.adaptive_deadline:
                if reason == "full":  # sustained load: waiting only adds latency
                    eff = max(dmin, eff / 2)
                elif reason == "deadline" and mb.n_queries < cfg.max_batch / 4:
                    eff = min(dmax, eff * 1.5)  # idle: wait longer, coalesce more
                with self._lock:
                    self._deadlines.append(eff)
                self._g_deadline.set(eff)
            pending, pend_q = [], 0

        while True:
            if pending:
                left = eff - (time.perf_counter() - pending[0].t_submit)
                if left <= 0:
                    item = None
                else:
                    try:
                        item = self._inq.get(timeout=left)
                    except queue.Empty:
                        item = None
            else:
                item = self._inq.get()
            if item is _STOP:
                if pending:
                    flush("stop")
                for _ in range(cfg.workers):
                    self._mbq.put(_STOP)
                self._updq.put(_STOP)  # updater (if any) drains, then exits
                return
            if isinstance(item, _UpdateReq):
                # Update barrier: requests already pending were submitted
                # before the update, so they flush (and pin) first; the
                # single updater then applies in submission order.
                if pending:
                    flush("barrier")
                self._updq.put(item)
                continue
            if item is not None:
                # A request that would overflow the launch flushes what's
                # pending first, so a batch never exceeds max_batch queries.
                if pend_q and pend_q + item.l.size > cfg.max_batch:
                    flush("full")
                pending.append(item)
                pend_q += item.l.size
            if pending:
                if pend_q >= cfg.max_batch:
                    flush("full")
                elif time.perf_counter() - pending[0].t_submit >= eff:
                    flush("deadline")

    def _worker_main(self, slot: int):
        """Supervised worker entry: a crash reports the slot and dies.

        Everything short of an injected kill is absorbed inside
        ``_worker_loop`` (a failed launch fails or requeues only its own
        batch); an escaping exception means the thread is gone, so the
        supervisor is told which slot to restart.
        """
        try:
            self._worker_loop(slot)
        except BaseException:
            self._deaths.put(slot)

    def _worker_loop(self, slot: int = 0):
        while True:
            item = self._mbq.get()
            if item is _STOP:
                return
            mb, reqs, ver, fs = item
            try:
                parts, splits, degraded = self._launch(mb, ver, fs)
            except BaseException as e:
                # Failed launch: its requests retry or fail — never the whole
                # server. An injected crash additionally kills this worker
                # thread (after the batch is requeued) to exercise the
                # supervisor's restart path.
                self._requeue_or_fail(mb, reqs, ver, fs, e)
                if isinstance(e, InjectedFault) and e.kind == "crash":
                    raise
                continue
            self._finish(mb, reqs, ver, fs, parts, splits, degraded)

    def _launch_span(self, fs, ver, mb: MicroBatch, pool: str):
        """Context manager for one engine launch span under flush span ``fs``
        (the worker thread — cross-thread, so the parent is explicit)."""
        attrs = dict(self._trace_attrs)
        attrs["pool"] = pool
        if ver is not None:
            attrs["version"] = ver.vid
        attrs["padded"] = mb.padded_size
        attrs["queries"] = int(mb.n_queries)
        return self._tracer.span("launch", parent=fs, attrs=attrs)

    def _launch(self, mb: MicroBatch, ver, fs=None):
        """One engine launch -> (per-request parts, regime splits, degraded?).

        Routes to the degraded fallback while the breaker is open; otherwise
        runs the primary engine, feeding the breaker's consecutive-failure
        count on each outcome. The results reach the host in
        ``scatter_back``, so the launch time includes the device's work.
        """
        if self._use_degraded():
            return self._launch_degraded(mb, ver, fs)
        tr = self._tracer
        self._m_launches["primary"].inc()
        try:
            # Observe how the range-adaptive dispatcher (if any) splits
            # this launch: a thread-local sink, so concurrent workers
            # never see each other's splits.
            splits: List[Tuple[int, int]] = []
            lsp = None
            t0 = time.perf_counter()
            with _hybrid.record_splits(lambda s, g: splits.append((s, g))):
                cm = self._launch_span(fs, ver, mb, "primary") if tr.enabled else tr.span("launch")
                with cm as lsp:
                    if self._fault is not None:
                        self._fault("worker_query")
                    if ver is not None:
                        idx, val = self._online.query(ver.state, mb.l, mb.r)
                    else:
                        idx, val = self._query_fn(mb.l, mb.r)
            # The coalesced launch is power-of-two padded with trivial
            # (0, 0) queries; the dispatcher routes ALL pads to one side
            # (short when threshold >= 1, else long — real queries never
            # leave that side short of the pad count), so subtracting
            # from whichever side holds them leaves real-traffic splits.
            pad = mb.l.size - mb.n_queries
            splits = [(s - pad, g) if s >= pad else (s, g - pad) for s, g in splits]
            if splits and tr.enabled and lsp is not None:
                lsp.set_attr("short", sum(s for s, _ in splits))
                lsp.set_attr("long", sum(g for _, g in splits))
            with tr.span("scatter", parent=fs):
                parts = scatter_back(mb, idx, val)
            self._h_launch["primary"].observe(time.perf_counter() - t0)
        except BaseException:
            self._breaker_failure()
            raise
        self._breaker_success()
        return parts, splits, False

    def _launch_degraded(self, mb: MicroBatch, ver, fs=None):
        """Answer via the correct-but-slower fallback path (breaker open):
        an online server's answers come from a plain sparse table over its
        pinned version's host array."""
        tr = self._tracer
        self._m_launches["degraded"].inc()
        t0 = time.perf_counter()
        cm = self._launch_span(fs, ver, mb, "degraded") if tr.enabled else tr.span("launch")
        with cm:
            if self._online is not None:
                if self._degraded is None:
                    from repro_torch.fault.fallback import DegradedFallback

                    self._degraded = DegradedFallback(device=self._online.device)
                idx, val = self._degraded.query(ver, mb.l, mb.r)
            else:
                idx, val = self._fallback_fn(mb.l, mb.r)
        with tr.span("scatter", parent=fs):
            parts = scatter_back(mb, idx, val)
        self._h_launch["degraded"].observe(time.perf_counter() - t0)
        return parts, [], True

    # -- circuit breaker ------------------------------------------------------

    def _use_degraded(self) -> bool:
        """True while the breaker routes launches to the fallback.

        closed -> open after ``breaker_threshold`` consecutive primary
        failures; open -> half-open once ``breaker_cooldown_s`` elapses (ONE
        worker runs a trivial health probe through the primary; the rest stay
        degraded); probe success closes, probe failure re-arms the cooldown.
        """
        if self._cfg.breaker_threshold <= 0:
            return False
        with self._lock:
            if not self._brk_open:
                return False
            cooled = time.perf_counter() - self._brk_opened_t >= self._cfg.breaker_cooldown_s
            if not cooled or self._brk_probing:
                return True
            self._brk_probing = True  # this worker owns the health probe
        ok = False
        try:
            ok = self._probe_primary()
        finally:
            with self._lock:
                self._brk_probing = False
                if ok:
                    self._brk_open = False
                    self._brk_fails = 0
                else:
                    self._brk_opened_t = time.perf_counter()  # re-arm cooldown
        return not ok

    def _probe_primary(self) -> bool:
        """Half-open health probe: one trivial query through the primary."""
        try:
            zeros = np.zeros(1, np.int32)
            if self._fault is not None:
                self._fault("worker_query")
            if self._online is not None:
                ver = self._online.pin()
                try:
                    out = self._online.query(ver.state, zeros, zeros)
                    scatter_back(coalesce([zeros], [zeros]), *out)
                finally:
                    self._online.release(ver.vid)
            else:
                scatter_back(coalesce([zeros], [zeros]), *self._query_fn(zeros, zeros))
            return True
        except BaseException:
            return False

    def _breaker_failure(self):
        if self._cfg.breaker_threshold <= 0:
            return
        with self._lock:
            self._brk_fails += 1
            if not self._brk_open and self._brk_fails >= self._cfg.breaker_threshold:
                self._brk_open = True
                self._brk_opened_t = time.perf_counter()
                self._m_trips.inc()

    def _breaker_success(self):
        if self._cfg.breaker_threshold <= 0:
            return
        with self._lock:
            self._brk_fails = 0

    # -- launch outcome plumbing ----------------------------------------------

    def _requeue_or_fail(self, mb: MicroBatch, reqs, ver, fs, err: BaseException):
        """Split a failed batch's requests into automatic retries and failures.

        A request retries while it has retry budget left, hasn't blown its
        ``request_timeout_s`` deadline, and the server is still open; retried
        requests re-enter the batcher (fresh coalescing, fresh version pin).
        The rest fail with a typed ``EngineFailure`` carrying the cause.
        """
        tr = self._tracer
        if ver is not None:
            self._online.release(ver.vid)
        if fs is not None:
            fs.set_attr("error", type(err).__name__)
            tr.finish(fs)
        now = time.perf_counter()
        retry, fail = [], []
        for q in reqs:
            expired = (
                self._cfg.request_timeout_s is not None
                and now - q.t_submit > self._cfg.request_timeout_s
            )
            if q.retries < self._cfg.max_retries and not expired and not self._closed:
                q.retries += 1
                retry.append(q)
            else:
                fail.append(q)
        with self._lock:
            self._inflight -= len(fail)
            self._m_out["retried"].inc(len(retry))
            self._m_out["failed"].inc(len(fail))
            for q in fail:
                self._live.discard(q)
            if retry and not self._closed:
                for q in retry:
                    # Back into the batcher: a fresh coalescing wait, so a
                    # fresh queue span under the same request root.
                    if q.span is not None:
                        q.qspan = tr.start("queue", parent=q.span)
                    self._inq.put(q)
                retry = []
            else:
                # close() raced us: its _STOP is already in _inq, so requeued
                # requests would never flush. Fail them instead.
                self._inflight -= len(retry)
                self._m_out["failed"].inc(len(retry))
                for q in retry:
                    self._live.discard(q)
            self._g_inflight.set(self._inflight)
        fail += retry
        if isinstance(err, (EngineFailure, DeadlineExceeded)):
            exc = err
        else:
            exc = EngineFailure(f"engine launch failed: {err!r}", cause=err)
        for q in fail:
            self._trace_resolve(q, "failed")
            self._fail_future(q, exc)

    def _finish(self, mb: MicroBatch, reqs, ver, fs, parts, splits, degraded: bool):
        tr = self._tracer
        t_done = time.perf_counter()
        lag = 0
        if ver is not None:
            lag = self._online.current_vid - ver.vid
            self._online.release(ver.vid)
        if fs is not None:
            if ver is not None:
                fs.set_attr("lag", lag)
            tr.finish(fs)
        with self._lock:
            self._inflight -= len(reqs)
            self._g_inflight.set(self._inflight)
            self._splits.extend(splits)
            self._padded.add(mb.padded_size)
            for q in reqs:
                self._live.discard(q)
            if ver is not None:
                self._lags.append(lag)
                self._g_vlag.set(lag)
            self._t_last_done = t_done
        self._m_batches.inc()
        self._m_queries.inc(int(mb.n_queries))
        self._m_out["served"].inc(len(reqs))
        for s, g in splits:
            self._m_regime["short"].inc(s)
            self._m_regime["long"].inc(g)
        for q, (qi, qv) in zip(reqs, parts):
            self._h_queue.observe(q.t_flush - q.t_submit)
            self._h_service.observe(t_done - q.t_flush)
            self._h_total.observe(t_done - q.t_submit)
            self._trace_resolve(q, "ok")
            try:
                q.future.set_result(
                    RequestResult(
                        qi,
                        qv,
                        RequestTiming(
                            q.t_flush - q.t_submit, t_done - q.t_flush, t_done - q.t_submit
                        ),
                        ver.vid if ver is not None else None,
                    )
                )
            except Exception:
                pass  # already failed (expired/closed): result has no taker

    def _trace_resolve(self, q, outcome: str):
        """Terminal span bookkeeping for one request: close any open queue
        span, emit the ``resolve`` child, finish the root. Idempotent — the
        first terminal outcome wins (a request can reach here twice when
        close() races a worker)."""
        if q.span is None:
            return
        tr = self._tracer
        if q.qspan is not None:
            tr.finish(q.qspan)
            q.qspan = None
        tr.instant("resolve", parent=q.span, attrs={"outcome": outcome})
        tr.finish(q.span)
        q.span = None

    @staticmethod
    def _fail_future(q, exc: BaseException):
        try:
            q.future.set_exception(exc)
        except Exception:
            pass  # already resolved

    def _supervisor_loop(self):
        """Restart crashed workers with capped exponential backoff per slot."""
        delay = {}
        while True:
            slot = self._deaths.get()
            if slot is _STOP:
                return
            d = delay.get(slot, self._cfg.worker_backoff_s)
            delay[slot] = min(d * 2, self._cfg.worker_backoff_max_s)
            time.sleep(d)
            with self._lock:
                if self._closed:
                    continue  # shutting down: _STOP already drained the pool
                self._m_restarts.inc()
                t = threading.Thread(
                    target=self._worker_main,
                    args=(slot,),
                    daemon=True,
                    name=f"rmq-worker-{slot}r",
                )
                self._threads.append(t)
            t.start()

    def _update_loop(self):
        """The single updater: applies update batches in submission order."""
        tr = self._tracer
        while True:
            item = self._updq.get()
            if item is _STOP:
                return
            try:
                # The update root span: OnlineEngine.apply's coalesce span
                # and the apply_deltas/publish stage spans (via run_stages)
                # nest under it ambiently — same thread, same context.
                if tr.enabled:
                    cm = tr.span("update", parent=0, attrs={"queue_s": time.perf_counter() - item.t_submit})
                else:
                    cm = tr.span("update")
                with cm as us:
                    res = self._online.apply(item.deltas)
                    us.set_attr("version", getattr(res, "version", None))
            except BaseException as e:
                # Malformed batches are rejected with the engine untouched;
                # a mid-patch failure fail-stops the OnlineEngine (later
                # applies raise) while queries keep serving published
                # versions. Either way, fail this future and keep going.
                with self._lock:
                    self._inflight -= 1
                    self._g_inflight.set(self._inflight)
                    self._live.discard(item)
                self._m_updates["failed"].inc()
                self._fail_future(item, e)
                continue
            with self._lock:
                self._inflight -= 1
                self._g_inflight.set(self._inflight)
                self._live.discard(item)
            self._m_updates["applied"].inc()
            self._h_update.observe(time.perf_counter() - item.t_submit)
            try:
                item.future.set_result(res)
            except Exception:
                pass  # already failed (server closed under us)

    def stats(self) -> ServeStats:
        """Render the ServeStats snapshot FROM the metrics registry.

        The NamedTuple is a *view*: every scalar comes from a registry
        instrument (so registry totals and ServeStats reconcile exactly, by
        construction) and the percentiles come from the histogram
        reservoirs. Only structural sequences (splits, lags, padded shapes,
        deadline trajectory) live outside the registry.
        """
        with self._lock:
            lags = tuple(self._lags)
            splits = tuple(self._splits)
            padded = tuple(sorted(self._padded))
            deadlines = tuple(self._deadlines)
            t0, t1 = self._t_first_submit, self._t_last_done
        nreq = self._h_total.count
        nq = int(self._m_queries.value)
        nb = int(self._m_batches.value)
        span = t1 - t0 if nreq and t0 is not None and t1 is not None else 0.0
        q50, q99 = self._h_queue.percentiles((50, 99))
        t50, t99 = self._h_total.percentiles((50, 99))
        u50, u99 = self._h_update.percentiles((50, 99))
        return ServeStats(
            served_requests=nreq,
            served_queries=nq,
            rejected_requests=int(self._m_out["rejected"].value),
            n_batches=nb,
            mean_batch_requests=nreq / nb if nb else 0.0,
            mean_batch_queries=nq / nb if nb else 0.0,
            padded_sizes=padded,
            p50_queue_s=q50,
            p99_queue_s=q99,
            p50_total_s=t50,
            p99_total_s=t99,
            throughput_qps=nq / span if span > 0 else 0.0,
            regime_splits=splits,
            deadline_trajectory=deadlines,
            applied_updates=self._h_update.count,
            p50_update_s=u50,
            p99_update_s=u99,
            version_lags=lags,
            degraded_launches=int(self._m_launches["degraded"].value),
            worker_restarts=int(self._m_restarts.value),
            retried_requests=int(self._m_out["retried"].value),
            expired_requests=int(self._m_out["expired"].value),
            failed_requests=int(self._m_out["failed"].value),
            breaker_trips=int(self._m_trips.value),
        )
