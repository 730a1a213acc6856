"""The device's peak of allocated memory, from a reset just before the
program's build to the end of the window, in GiB (2^30 bytes)."""

NEEDS = {"card": "the peak is the CUDA allocator's; a CPU run has none"}


def read(ctx):
    p = ctx["peak_bytes"]
    return p / 2**30 if p else None
