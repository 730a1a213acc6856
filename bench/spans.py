"""What the program records of itself in a traced run, for the per-layer
readers.

- Spans: ``repro_torch``'s ``Tracer.span`` enters
  ``torch.profiler.record_function`` while the profiler records, so each of
  its spans is a host event of the traced slice, on the clock of the device
  operations.
- Counters and histograms: ``repro_torch.obs.metrics.default_registry()``,
  the program's process-wide registry, read after the run.

A program without a span or an instrument reads None, never 0.
"""

from __future__ import annotations

__all__ = ["path_device_ms", "span_ms"]


def span_ms(ctx, name: str):
    """The summed duration of the host events named exactly ``name``, each
    clipped to the slice's ``[lo_us, hi_us]``, per batch of the slice, in
    ms; None where the slice holds no such event or no batch."""
    sl = ctx["slice"]
    if not sl or not sl["batches"]:
        return None
    lo, hi = sl["lo_us"], sl["hi_us"]
    spans = [(max(s, lo), min(e, hi)) for n, s, e in sl["host_events"] if n == name and e > lo and s < hi]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / sl["batches"]


def path_device_ms(path: str):
    """The mean of the program's ``dispatch_path_device_s{path=<path>}``
    histogram in ms: one path's device time per launch, from CUDA events;
    None where it holds no observation."""
    from repro_torch.obs.metrics import default_registry

    for name, h in default_registry().histograms():
        if name == "dispatch_path_device_s" and h.labels.get("path") == path and h.count:
            return h.mean() * 1e3
    return None
