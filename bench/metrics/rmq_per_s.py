"""Range minima answered per second: every query of the window over the
window's seconds, from the first call to the last answer synchronized."""


def read(ctx):
    w = ctx["window"]
    return w["queries"] / w["seconds"] if w["seconds"] > 0 else None
