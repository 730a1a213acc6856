"""Host time per batch of the traced slice in the program's
``dispatch.bounds`` spans: the bounds' type checked, the length mask and the
batch's one read of three numbers (least bound, greatest bound, short count)
where the bounds live, the range check, and host bounds copied to the
device, in ms."""

from bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch.bounds")
