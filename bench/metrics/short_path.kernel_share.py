"""The share (%) of the short path's queries that a CUDA kernel served: the
program's ``query_kernel_queries_total`` (each launch of a query kernel adds
its batch size) over its ``dispatch_launched_queries_total{path=short}``
(the queries dispatch launched on the short path, pads included). Both are
counted over the whole run, warm-up, window and traced slice: the registry
is the process's, and a run is one process. 100 when a kernel serves every
short launch, 0 when torch ops serve them. None without a card (the traced
slice holds no device operation) or where the program has no such
counters."""

NEEDS = {"card": "the query kernels run on a card only; on the CPU the short path is torch ops"}


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device_events"]:
        return None
    from repro_torch.obs.metrics import default_registry

    reg = default_registry()
    if "dispatch_launched_queries_total" not in {name for name, _ in reg.counters()}:
        return None
    launched = reg.counter_total("dispatch_launched_queries_total", path="short")
    if not launched:
        return None
    return 100.0 * reg.counter_total("query_kernel_queries_total") / launched
