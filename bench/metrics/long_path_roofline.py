"""The long path's share (%) of the HBM roofline in the traced slice: 16
bytes per query that dispatch routed to it, at 3.35 TB/s, over the device
time of every other compute operation (not a copy or a memset, not a
``csrc`` kernel)."""

from bench import roofline

NEEDS = {
    "card": "the profiler records device operations on a card only",
    "long": "without a query routed long the long path has no work to share",
}


def read(ctx):
    sl = ctx["slice"]
    if not sl:
        return None
    us = sum(
        e - s
        for name, s, e in sl["device_events"]
        if not (roofline.is_copy(name) or roofline.is_memset(name) or roofline.is_csrc(name))
    )
    return roofline.roofline_pct(sl["long_queries"], us / 1e6)
