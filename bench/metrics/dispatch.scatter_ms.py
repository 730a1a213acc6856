"""Host time per batch of the traced slice in the program's
``dispatch.scatter`` spans: a mixed batch's answers brought to the host,
put back into batch order and copied to the device, in ms."""

from bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch.scatter")
