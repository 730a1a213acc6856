"""The 95th percentile (numpy's linear interpolation) over every batch of
the window of its time from the call into ``query`` to the answers
synchronized, in ms."""

import numpy as np


def read(ctx):
    b = ctx["window"]["batch_s"]
    return float(np.percentile(b, 95)) * 1e3 if b else None
