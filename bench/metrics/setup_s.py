"""Set-up: from the start of the process (before torch is imported) to the
first call of the window: start-up, the array and the pool, the build, the
kernels' load (their build, in a checkout's first run) and the warm-up."""


def read(ctx):
    return ctx["setup_s"]
