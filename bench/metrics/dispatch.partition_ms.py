"""Host time per batch of the traced slice in the program's
``dispatch.partition`` spans: the batch split by range length, each path's
bounds padded to a power of two and copied to the device, in ms."""

from bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch.partition")
