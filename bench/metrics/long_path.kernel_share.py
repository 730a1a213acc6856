"""The share (%) of the long path's queries that a CUDA kernel served: the
program's ``sparse_query_queries_total`` (each launch of the doubling-table
query kernel adds its batch size) over its
``dispatch_launched_queries_total{path=long}`` (the queries dispatch
launched on the long path, pads included). Both are counted over the whole
run, warm-up, window and traced slice: the registry is the process's, and
a run is one process. 100 when the kernel serves every long launch, 0 when
torch ops serve them. None without a card (the traced slice holds no device
operation), without a long launch, or where the program has no such kernel
or counters."""

NEEDS = {
    "card": "the doubling-table query kernel runs on a card only; on the CPU the long path is torch ops",
    "long": "the long path launches only for a batch with a query routed long",
}


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device_events"]:
        return None
    try:
        import repro_torch.kernels.sparse_query  # noqa: F401  (a program without the kernel has no counter)
    except ImportError:
        return None
    from repro_torch.obs.metrics import default_registry

    reg = default_registry()
    if "dispatch_launched_queries_total" not in {name for name, _ in reg.counters()}:
        return None
    launched = reg.counter_total("dispatch_launched_queries_total", path="long")
    if not launched:
        return None
    return 100.0 * reg.counter_total("sparse_query_queries_total") / launched
