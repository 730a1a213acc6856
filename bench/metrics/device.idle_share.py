"""The device's idle share (%) of the traced slice: 1 - busy / wall, busy
the union of its operations' intervals, on the profiler's clock."""

from bench import roofline

NEEDS = {"card": "the profiler records device operations on a card only"}


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device_events"]:
        return None
    lo, hi = sl["lo_us"], sl["hi_us"]
    return 100.0 * (1.0 - roofline.busy_seconds(sl["device_events"], lo, hi) / ((hi - lo) / 1e6))
