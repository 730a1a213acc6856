"""``core.hybrid.dispatch_by_length`` on the CPU, with fake paths that record
what they get.

One parametrised test over bound containers (int32 and int64 tensors, int32
and int64 numpy arrays, lists) and batches: each path gets its queries in
batch order, padded to a power of two with (0, 0) queries, the answers come
back in batch order, and a length exactly at the threshold routes short. The
same cases hold the errors (non-integer bounds, bounds outside int32 or of
unequal length, with nothing launched), the ``record_splits`` callback, the
``dispatch`` span's attrs and one read of the three numbers a non-empty
batch (``dispatch_host_syncs_total``). No structure is built: the file runs in a
second.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hybrid
from repro_torch.obs import metrics, trace

I32 = 2**31 - 1
CODE = {"short": 0, "long": 1}

# name -> (l, r, threshold, (expected error, message pattern) or None)
CASES = {
    "all_short": ([0, 5, 9], [0, 6, 12], 4, None),
    "all_long": ([0, 10], [9, 30], 4, None),
    "one_short_among_many": ([0, 7, 3, 40, 2, 11, 5, 60, 8], [50, 40, 4, 99, 70, 90, 80, 99, 90], 4, None),
    "at_and_above_threshold": ([0, 0, 6], [3, 4, 9], 4, None),
    "threshold_0": ([0, 3], [0, 7], 0, None),
    "threshold_past_int32": ([0, 0, 7], [I32, 5, 9], 2**31, None),
    "full_int32_range_routes_long": ([1, 0, 3], [1, I32, 3], 10**6, None),
    "empty": ([], [], 4, None),
    "float_bounds": ([0.0], [1.0], 4, (TypeError, "integer")),
    "bool_bounds": ([False], [True], 4, (TypeError, "integer")),
    "negative_bound": ([-1, 0], [2, 3], 4, (ValueError, "int32")),
    "past_int32": ([0, 1], [2**31, 3], 4, (ValueError, "int32")),
    "unequal_lengths": ([5], [6, 7, 9], 4, (ValueError, "unequal length")),
}

KINDS = ("torch_int32", "torch_int64", "numpy_int32", "numpy_int64", "list")


def _as(kind, a, case):
    if case == "float_bounds":
        dtype = {"torch_int32": torch.float32, "torch_int64": torch.float64}.get(kind, np.float64)
    elif case == "bool_bounds":
        dtype = torch.bool if kind.startswith("torch") else bool
    else:
        dtype = {
            "torch_int32": torch.int32,
            "torch_int64": torch.int64,
            "numpy_int32": np.int32,
            "numpy_int64": np.int64,
        }.get(kind)
    if kind == "list":
        return [dtype(v) for v in a] if dtype else list(a)
    if kind.startswith("torch"):
        return torch.tensor(a, dtype=dtype)
    return np.array(a, dtype=dtype)


def _pad(v):
    kp = 1 << (len(v) - 1).bit_length() if len(v) > 1 else 1
    return v + [0] * (kp - len(v))


PARAMS = [
    (kind, case)
    for case in CASES
    for kind in KINDS
    # int32 cannot hold a bound past int32; an empty list has no integer dtype
    if not (case == "past_int32" and kind.endswith("int32")) and not (case == "empty" and kind == "list")
]


@pytest.mark.parametrize("kind,case", PARAMS, ids=[f"{c}-{k}" for k, c in PARAMS])
def test_dispatch_routes_pads_and_scatters_on_the_bounds_device(kind, case, monkeypatch):
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", reg)
    l0, r0, threshold, error = CASES[case]
    seen = []

    def path(tag):
        def run(l, r):
            seen.append((tag, l.tolist(), r.tolist(), l.dtype, r.dtype, l.device))
            return l.clone(), r.to(torch.int64) * 2 + CODE[tag]

        return run

    splits = []
    tracer = trace.Tracer()
    prev = trace.set_tracer(tracer)
    try:
        with hybrid.record_splits(lambda s, g: splits.append((s, g))):
            call = lambda: hybrid.dispatch_by_length(
                _as(kind, l0, case), _as(kind, r0, case), threshold, path("short"), path("long"),
                torch.int64, torch.device("cpu"),
            )
            if error is not None:
                with pytest.raises(error[0], match=error[1]):
                    call()
            else:
                idx, val = call()
    finally:
        trace.set_tracer(prev)

    assert reg.counter_total("dispatch_batches_total") == 1
    assert reg.counter_total("dispatch_copy_bytes_total") == 0  # nothing to copy on the CPU
    # One read of the three numbers per non-empty batch; the dtype and length
    # checks need none.
    syncs = 0 if case in ("empty", "float_bounds", "bool_bounds", "unequal_lengths") else 1
    assert reg.counter_total("dispatch_host_syncs_total") == syncs
    if error is not None:
        assert seen == [] and splits == []  # nothing launched
        return

    route = ["short" if b - a + 1 <= threshold else "long" for a, b in zip(l0, r0)]
    want = [
        (tag, _pad([a for a, p in zip(l0, route) if p == tag]), _pad([b for b, p in zip(r0, route) if p == tag]),
         torch.int32, torch.int32, torch.device("cpu"))
        for tag in ("short", "long")
        if tag in route
    ]
    assert seen == want
    assert idx.dtype == torch.int32 and idx.tolist() == l0  # answers back in batch order
    assert val.dtype == torch.int64 and val.tolist() == [2 * b + CODE[p] for b, p in zip(r0, route)]
    n_short = route.count("short")
    if case == "empty":
        assert splits == [] and idx.shape == (0,)
        return
    assert splits == [(n_short, len(route) - n_short)]
    (root,) = [s for s in tracer.spans() if s.name == "dispatch"]
    assert root.attrs == {"short": n_short, "long": len(route) - n_short}
