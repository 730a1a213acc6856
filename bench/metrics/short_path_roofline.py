"""The short path's share (%) of the HBM roofline in the traced slice: 16
bytes per query that dispatch routed to it, at 3.35 TB/s, over the device
time of the port's ``csrc`` query kernels (by name)."""

from bench import roofline

NEEDS = {
    "card": "the profiler records device operations on a card only",
    "short": "without a query routed short the short path has no work to share",
    "kernel": "the share is of the CUDA query kernels' time; a short path of torch ops has none",
}


def read(ctx):
    sl = ctx["slice"]
    if not sl:
        return None
    us = sum(e - s for name, s, e in sl["device_events"] if roofline.is_csrc_query(name))
    return roofline.roofline_pct(sl["short_queries"], us / 1e6)
