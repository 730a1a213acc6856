"""Observability layer: span tracing + metrics registry (DESIGN.md §14).

``repro_torch.obs.trace`` records request/update/build lifecycle spans into a
ring buffer and exports Chrome-trace JSON (open at https://ui.perfetto.dev);
``repro_torch.obs.metrics`` is the process-wide counter/gauge/histogram registry
that ``ServeStats`` snapshots are rendered from. Both are dependency-free
w.r.t. the rest of ``repro_torch`` so any layer may import them.
"""

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    merge_snapshots,
    reset_default_registry,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    Span,
    Tracer,
    current_span,
    get_tracer,
    set_attr,
    set_tracer,
    verify_request_chains,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "Span",
    "Tracer",
    "current_span",
    "default_registry",
    "get_tracer",
    "merge_snapshots",
    "reset_default_registry",
    "set_attr",
    "set_tracer",
    "verify_request_chains",
]
