"""Host time per batch of the traced slice in the program's
``dispatch.bounds`` spans: the bounds brought to the host, checked and
widened to int64, in ms."""

from bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch.bounds")
