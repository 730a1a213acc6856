"""Host time per batch of the traced slice in the program's
``dispatch.scatter`` spans: a mixed batch's answers of both paths gathered
into batch order on the device, in ms."""

from bench.spans import span_ms

NEEDS = {"mixed": "only a batch that holds both short and long queries is scattered"}


def read(ctx):
    return span_ms(ctx, "dispatch.scatter")
