"""Host time per batch of the traced slice in the program's
``dispatch.partition`` spans: the split recorded; a uniform batch padded to
a power of two, or a mixed batch's slot map built on the device and its
bounds scattered into the two padded sub-batches, in ms."""

from bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch.partition")
