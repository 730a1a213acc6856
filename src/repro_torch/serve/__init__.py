"""Async micro-batching serve subsystem.

    submit(l, r) ─► admission control ─► request queue
        └─► deadline micro-batcher (coalesce + power-of-two pad)
              └─► engine-pool workers (any ``(l, r) -> (idx, val)`` engine)
                    └─► exact per-request scatter-back + latency stamps

``batcher`` is the pure coalescing/padding/scatter core; ``server.RMQServer``
wires it to a bounded request queue, a deadline flush loop and a worker
pool, and over an online engine (``online=``, ``repro_torch.update``) to a
single updater thread behind ``submit_update``, each launch pinning a
version (``RequestResult.version``, the update fields of ``ServeStats``); ``workload`` provides the paper's §6.4 range distributions (int32 at
the boundary) and open-loop Poisson clients. ``batcher`` and ``workload``
are copies of the reference's modules.
"""

from .batcher import MicroBatch, bucket, coalesce, scatter_back
from .server import (
    DeadlineExceeded,
    EngineFailure,
    RMQServer,
    RequestResult,
    RequestTiming,
    ServeConfig,
    ServeStats,
    ServerClosed,
    ServerOverloaded,
)
from .workload import make_queries, poisson_interarrivals, run_poisson_clients

__all__ = [
    "DeadlineExceeded",
    "EngineFailure",
    "MicroBatch",
    "RMQServer",
    "RequestResult",
    "RequestTiming",
    "ServeConfig",
    "ServeStats",
    "ServerClosed",
    "ServerOverloaded",
    "bucket",
    "coalesce",
    "make_queries",
    "poisson_interarrivals",
    "run_poisson_clients",
    "scatter_back",
]
