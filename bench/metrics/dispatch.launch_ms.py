"""Host time per batch of the traced slice in the program's
``dispatch.launch`` spans, one per path launched: the call of the path
(enqueue and the kernel wrapper's host work), summed over the paths, in
ms."""

from bench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch.launch")
