"""Helpers of the repro_torch parity tests: leaf-for-leaf structure equality.

Structures of both packages are NamedTuples (possibly nested, possibly in
tuples) of arrays; non-array leaves (configs, closures, ints) are skipped.
"""

import numpy as np
import torch


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _is_array(a) -> bool:
    return isinstance(a, (torch.Tensor, np.ndarray)) or (
        hasattr(a, "shape") and hasattr(a, "dtype") and hasattr(a, "__array__")
    )


def leaves(s, path="s"):
    """[(path, array)] of every array leaf, depth first in field order."""
    if _is_array(s):
        return [(path, s)]
    if isinstance(s, tuple) and hasattr(s, "_fields"):
        out = []
        for name, v in zip(s._fields, s):
            out += leaves(v, f"{path}.{name}")
        return out
    if isinstance(s, (tuple, list)):
        out = []
        for i, v in enumerate(s):
            out += leaves(v, f"{path}[{i}]")
        return out
    return []


def assert_same_structure(ref, port):
    """Equal leaf for leaf: same field paths, dtypes, shapes and values."""
    a, b = leaves(ref), leaves(port)
    assert [p for p, _ in a] == [p for p, _ in b], ([p for p, _ in a], [p for p, _ in b])
    assert a, "no array leaves"
    for (path, x), (_, y) in zip(a, b):
        x, y = to_np(x), to_np(y)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=path)


def assert_same_answer(ref_out, port_out, x=None, gold=None):
    """(idx, val) equal exactly, idx int32 on both sides, val of x's dtype."""
    ri, rv = (to_np(a) for a in ref_out)
    pi, pv = port_out
    assert pi.dtype == torch.int32, pi.dtype
    pi, pv = to_np(pi), to_np(pv)
    assert ri.dtype == pi.dtype == np.int32, (ri.dtype, pi.dtype)
    assert rv.dtype == pv.dtype, (rv.dtype, pv.dtype)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv, rv)
    if x is not None:
        assert pv.dtype == np.asarray(x).dtype
    if gold is not None:
        np.testing.assert_array_equal(pi, gold)
        np.testing.assert_array_equal(pv, np.asarray(x)[gold])
