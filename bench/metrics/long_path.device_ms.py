"""The long path's device time per launch, from the CUDA events the program
records around each launch while tracing (the traced slice): the mean of
its ``dispatch_path_device_s{path=long}`` histogram in
``repro_torch.obs.metrics.default_registry()``, in ms. None where the
path never launched while tracing, or the program has no such histogram."""

from bench.spans import path_device_ms

NEEDS = {
    "card": "the program records its CUDA events on a card only",
    "long": "the long path launches only for a batch with a query routed long",
}


def read(ctx):
    return path_device_ms("long")
