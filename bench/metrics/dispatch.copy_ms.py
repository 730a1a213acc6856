"""Device time of the host<->device copies (``Memcpy`` operations) per batch
of the traced slice, in ms."""

from bench import roofline

NEEDS = {"card": "the profiler records copies on a card only; on the CPU nothing is copied"}


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device_events"] or not sl["batches"]:
        return None
    us = sum(e - s for name, s, e in sl["device_events"] if roofline.is_copy(name))
    return us / 1e3 / sl["batches"]
