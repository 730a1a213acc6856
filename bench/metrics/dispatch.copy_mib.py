"""MiB (2^20 bytes) copied between host and device per batch, both ways:
the program's ``dispatch_copy_bytes_total`` over its
``dispatch_batches_total`` (every batch of the run, warm-up and window too:
bounds on the card copy the 24 B of the batch's one read back, host bounds
their bytes up). None where the program counts no copy: on the CPU, or a
program without the counters."""

NEEDS = {"card": "bounds and structure on the CPU share the host: dispatch copies nothing"}


def read(ctx):
    from repro_torch.obs.metrics import default_registry

    reg = default_registry()
    if "dispatch_copy_bytes_total" not in {name for name, _ in reg.counters()}:
        return None
    batches = reg.counter_total("dispatch_batches_total")
    return reg.counter_total("dispatch_copy_bytes_total") / 2**20 / batches if batches else None
