"""Serving workloads: §6.4 range distributions + open-loop Poisson clients.

``make_queries`` is the single source of the paper's three query-range
regimes for the serving stack (``launch.serve`` and ``benchmarks.common``
both route here). It returns **int32** bounds: every engine computes int32
indices (the fused kernel, the blocked paths, the doubling tables), so the
int64 sampling intermediates are cast at this boundary, and ``n`` itself
must fit the int32 index range.

``run_poisson_clients`` is the one open-loop client fleet shared by the
serve CLI, the example, and the latency benchmark.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

__all__ = [
    "INT32_MAX",
    "make_queries",
    "poisson_interarrivals",
    "run_poisson_clients",
]

INT32_MAX = np.iinfo(np.int32).max


def make_queries(rng, n: int, batch: int, dist: str):
    """Paper §6.4 range distributions (large / medium / small) -> int32 (l, r).

    Large: uniform range length in [1, n]; Medium: LogNormal(log n^0.6, .3);
    Small: LogNormal(log n^0.3, .3).
    """
    if not 1 <= n <= INT32_MAX:
        raise ValueError(f"n={n} outside the engines' int32 index range")
    if dist == "large":
        length = rng.integers(1, n + 1, batch)
    else:
        exp = 0.6 if dist == "medium" else 0.3
        length = np.exp(rng.normal(np.log(n**exp), 0.3, batch))
        length = np.clip(length, 1, n).astype(np.int64)
    l = rng.integers(0, np.maximum(n - length + 1, 1), batch)
    r = np.minimum(l + length - 1, n - 1)
    return l.astype(np.int32), r.astype(np.int32)


def poisson_interarrivals(rng, rate_hz: float, count: int) -> np.ndarray:
    """Exponential interarrival gaps (seconds) for an open-loop Poisson client.

    ``rate_hz <= 0`` means "as fast as possible": zero gaps.
    """
    if rate_hz <= 0:
        return np.zeros(count)
    return rng.exponential(1.0 / rate_hz, count)


def run_poisson_clients(
    n_clients: int,
    requests: int,
    rate_hz: float,
    make_request: Callable,  # (rng, client_idx) -> (l, r)
    submit: Callable,  # (l, r) -> Future; may raise ServerOverloaded
    *,
    seed: int = 0,
) -> List[List[Tuple[tuple, Optional[object]]]]:
    """Open-loop Poisson client fleet against a server's ``submit``.

    Each of ``n_clients`` threads paces ``requests`` submissions at
    ``rate_hz`` (Poisson arrivals fixed in advance — a slow server cannot
    slow the offer down). Returns per-client lists of ``((l, r), future)``;
    ``future`` is ``None`` when admission control rejected, which an
    open-loop client answers by dropping and keeping its pace.
    """
    from .server import ServerOverloaded

    out: List[List[Tuple[tuple, Optional[object]]]] = [[] for _ in range(n_clients)]

    def client(c: int) -> None:
        # Sequence seeding: (seed, c) keys a distinct stream per (run, client).
        # The old `seed + c` collides across runs — (seed=0, client=1) and
        # (seed=1, client=0) replayed identical traffic.
        rng = np.random.default_rng([seed, c])
        for gap in poisson_interarrivals(rng, rate_hz, requests):
            if gap > 0:
                time.sleep(gap)
            l, r = make_request(rng, c)
            try:
                fut = submit(l, r)
            except ServerOverloaded:
                fut = None
            out[c].append(((l, r), fut))

    threads = [
        threading.Thread(target=client, args=(c,), name=f"poisson-client-{c}")
        for c in range(n_clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out
