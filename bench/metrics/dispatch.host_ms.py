"""The benchmark's own span around each call into ``query``: the host's wall
time per batch from the call to its return (before the wait for the
device), the mean over the window, in ms."""


def read(ctx):
    h = ctx["window"]["host_s"]
    return 1e3 * sum(h) / len(h) if h else None
