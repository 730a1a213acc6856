"""Async micro-batching serve subsystem.

    submit(l, r) ─► admission control ─► request queue
        └─► deadline micro-batcher (coalesce + power-of-two pad)
              └─► engine-pool workers (any ``(l, r) -> (idx, val)`` engine)
                    └─► exact per-request scatter-back + latency stamps

``batcher`` is the pure coalescing/padding/scatter core; ``server.RMQServer``
wires it to a bounded request queue, a deadline flush loop and a worker
pool, and over an online engine (``online=``, ``repro_torch.update``) to a
single updater thread behind ``submit_update``, each launch pinning a
version (``RequestResult.version``, the update fields of ``ServeStats``);
``workload`` provides the paper's §6.4 range distributions (int32 at the
boundary) and open-loop Poisson clients; ``fleet.RMQFleet`` runs N
replica servers behind one regime-routing, read-your-writes front door.
``batcher`` and ``workload`` are copies of the reference's modules.
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
    StaleVersion,
)
from .workload import make_queries, poisson_interarrivals, run_poisson_clients

# Fleet symbols resolve lazily (PEP 562): ``fleet`` is also a runnable soak
# (``python -m repro_torch.serve.fleet``), and importing it eagerly here
# would import it twice under runpy.
_FLEET_EXPORTS = ("FleetConfig", "FleetSession", "FleetStats", "RMQFleet")


def __getattr__(name):
    if name in _FLEET_EXPORTS:
        from . import fleet

        return getattr(fleet, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DeadlineExceeded",
    "EngineFailure",
    "FleetConfig",
    "FleetSession",
    "FleetStats",
    "MicroBatch",
    "RMQFleet",
    "RMQServer",
    "RequestResult",
    "RequestTiming",
    "ServeConfig",
    "ServeStats",
    "ServerClosed",
    "ServerOverloaded",
    "StaleVersion",
    "bucket",
    "coalesce",
    "make_queries",
    "poisson_interarrivals",
    "run_poisson_clients",
    "scatter_back",
]
