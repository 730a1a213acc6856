"""The host's wall time of the registry's ``build(x, device)``, ending in a
synchronize, in ms."""


def read(ctx):
    return ctx["build_s"] * 1e3
