"""Process-wide metrics registry (DESIGN.md §14).

Three instrument kinds, all thread-safe and cheap enough for the serve hot
path (one lock acquire + a couple of scalar ops per observation):

* ``Counter`` — monotone float/int total (``inc``).
* ``Gauge``   — last-written value (``set``), e.g. the adaptive deadline or
  a replica's version lag.
* ``Histogram`` — fixed-bucket counts (for cheap export/merging) **plus** a
  bounded reservoir of raw observations so ``percentile(q)`` is *exact*
  (numpy linear interpolation, the same math ``ServeStats`` always used)
  as long as the observation count stays within the reservoir capacity —
  the default capacity (65536) comfortably covers every test/benchmark
  workload in this repo, so ``ServeStats`` snapshots rendered from the
  registry are bit-identical to the old ad-hoc list accumulation. Past
  capacity it degrades to uniform reservoir sampling (Algorithm R), never
  unbounded memory.

Instruments are named + labelled: ``registry.counter("serve_requests_total",
outcome="served")`` get-or-creates the child keyed by the sorted label set,
so the serving layer can cache instrument handles once and skip the dict
work per observation. ``MetricsRegistry.snapshot()`` renders everything to
one plain-dict document; ``merge_snapshots`` relabels and concatenates
per-replica snapshots into a fleet-level view at the front door.

Intentionally stdlib+numpy only; no imports from the rest of ``repro_torch``.
"""

from __future__ import annotations

import bisect
import random
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "merge_snapshots",
]

# Default latency buckets (seconds): 100µs .. ~13s, factor ~2.
DEFAULT_BUCKETS = tuple(1e-4 * (2.0 ** k) for k in range(18))


def _label_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    __slots__ = ("labels", "_lock", "_value")

    def __init__(self, labels: Mapping[str, str]):
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    __slots__ = ("labels", "_lock", "_value")

    def __init__(self, labels: Mapping[str, str]):
        self.labels = dict(labels)
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed buckets + exact-until-capacity reservoir (module docstring)."""

    __slots__ = (
        "labels",
        "buckets",
        "capacity",
        "_lock",
        "_bucket_counts",
        "_count",
        "_sum",
        "_reservoir",
        "_rng",
    )

    def __init__(
        self,
        labels: Mapping[str, str],
        *,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        capacity: int = 65536,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.labels = dict(labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(self.buckets) + 1)  # +inf overflow
        self._count = 0
        self._sum = 0.0
        self._reservoir: List[float] = []
        self._rng = random.Random(0x5EED)  # deterministic sampling past capacity

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._bucket_counts[idx] += 1
            self._count += 1
            self._sum += value
            if len(self._reservoir) < self.capacity:
                self._reservoir.append(value)
            else:
                j = self._rng.randrange(self._count)
                if j < self.capacity:
                    self._reservoir[j] = value

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def values(self) -> List[float]:
        """The reservoir contents (== all observations while exact)."""
        with self._lock:
            return list(self._reservoir)

    def percentile(self, q: float) -> float:
        """Exact-from-reservoir percentile (numpy linear interpolation);
        0.0 when empty, matching the old ServeStats convention."""
        with self._lock:
            if not self._reservoir:
                return 0.0
            return float(np.percentile(self._reservoir, q))

    def percentiles(self, qs: Sequence[float]) -> List[float]:
        with self._lock:
            if not self._reservoir:
                return [0.0 for _ in qs]
            return [float(v) for v in np.percentile(self._reservoir, list(qs))]

    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0


class MetricsRegistry:
    """Name+labels → instrument, with get-or-create semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], Counter] = {}
        self._gauges: Dict[Tuple[str, tuple], Gauge] = {}
        self._hists: Dict[Tuple[str, tuple], Histogram] = {}

    def counter(self, name: str, **labels: str) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._counters.get(key)
            if inst is None:
                inst = self._counters[key] = Counter(labels)
            return inst

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._gauges.get(key)
            if inst is None:
                inst = self._gauges[key] = Gauge(labels)
            return inst

    def histogram(
        self,
        name: str,
        *,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        capacity: int = 65536,
        **labels: str,
    ) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._hists.get(key)
            if inst is None:
                inst = self._hists[key] = Histogram(
                    labels, buckets=buckets, capacity=capacity
                )
            return inst

    # -- iteration / export --------------------------------------------------

    def counters(self) -> List[Tuple[str, Counter]]:
        with self._lock:
            return [(k[0], v) for k, v in self._counters.items()]

    def gauges(self) -> List[Tuple[str, Gauge]]:
        with self._lock:
            return [(k[0], v) for k, v in self._gauges.items()]

    def histograms(self) -> List[Tuple[str, Histogram]]:
        with self._lock:
            return [(k[0], v) for k, v in self._hists.items()]

    def counter_total(self, name: str, **labels: str) -> float:
        """Sum of all counter children of ``name`` whose labels are a
        superset of ``labels`` (empty labels = family total)."""
        want = set(_label_key(labels))
        total = 0.0
        for n, c in self.counters():
            if n == name and want <= set(_label_key(c.labels)):
                total += c.value
        return total

    def snapshot(self) -> dict:
        """Everything as one JSON-ready document (lists of labelled rows
        per family; histograms summarized, raw reservoirs omitted)."""
        doc: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, c in self.counters():
            doc["counters"].setdefault(name, []).append(
                {"labels": dict(c.labels), "value": c.value}
            )
        for name, g in self.gauges():
            doc["gauges"].setdefault(name, []).append(
                {"labels": dict(g.labels), "value": g.value}
            )
        for name, h in self.histograms():
            p50, p95, p99 = h.percentiles((50, 95, 99))
            doc["histograms"].setdefault(name, []).append(
                {
                    "labels": dict(h.labels),
                    "count": h.count,
                    "sum": h.sum,
                    "mean": h.mean(),
                    "p50": p50,
                    "p95": p95,
                    "p99": p99,
                    "buckets": {
                        "le": list(h.buckets),
                        "counts": list(h._bucket_counts),
                    },
                }
            )
        return doc


_DEFAULT = MetricsRegistry()
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-global registry (fault/durable counters live here)."""
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh global registry (tests); returns the new one."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MetricsRegistry()
        return _DEFAULT


def merge_snapshots(
    snaps: Mapping[str, dict], *, label: str = "replica"
) -> dict:
    """Fleet-level aggregation: concatenate per-source snapshot rows,
    stamping each row's labels with ``label=<source key>``. Family totals
    then fall out of summing rows, and per-replica breakdowns survive."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for src, snap in snaps.items():
        for kind in ("counters", "gauges", "histograms"):
            for name, rows in snap.get(kind, {}).items():
                for row in rows:
                    merged = dict(row)
                    merged["labels"] = {**row.get("labels", {}), label: str(src)}
                    out[kind].setdefault(name, []).append(merged)
    return out
