"""The plain reference against a scan of every range, on small arrays with
ties, and the control's lower precisions."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import reference


def _scan(x: np.ndarray, l: np.ndarray, r: np.ndarray) -> np.ndarray:
    """The leftmost minimum of each range, one range at a time."""
    return np.array([a + int(np.argmin(x[a : b + 1])) for a, b in zip(l, r)], np.int32)


def _all_ranges(n: int):
    l, r = np.triu_indices(n)
    return l.astype(np.int32), r.astype(np.int32)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64, 100])
@pytest.mark.parametrize("kind", ["float_ties", "float_signed", "int_ties", "euler"])
def test_reference_equals_a_scan_of_every_range(n, kind):
    rng = np.random.default_rng(n)
    if kind == "float_ties":
        x = rng.integers(0, 4, n).astype(np.float32) / 4
    elif kind == "float_signed":
        x = np.concatenate([[-0.0, 0.0, -np.inf, np.inf], rng.normal(size=n)]).astype(np.float32)[:n]
    elif kind == "int_ties":
        x = rng.integers(-3, 3, n).astype(np.int32)
    else:
        x = np.cumsum(rng.choice([-1, 1], n)).astype(np.int32)
    l, r = _all_ranges(n)
    table = reference.build(torch.from_numpy(x))
    idx, val = reference.query(table, torch.from_numpy(l), torch.from_numpy(r))
    want = _scan(np.where(x == 0, 0, x).astype(x.dtype), l, r)  # -0.0 ties with +0.0
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(val.numpy(), x[want])


def test_floor_log2_is_exact_at_every_power_of_two():
    p = torch.tensor([1 << k for k in range(32)], dtype=torch.int64)
    want = torch.arange(32)
    assert torch.equal(reference.floor_log2(p), want)
    assert torch.equal(reference.floor_log2(p[1:] - 1), want[:-1])
    assert torch.equal(reference.floor_log2(p[2:] + 1), want[2:])


def test_keys_order_floats_as_values():
    x = torch.tensor([-np.inf, -3.5, -1e-30, 0.0, 1e-30, 2.0, np.inf], dtype=torch.float32)
    keys = reference.order_keys(x)
    assert bool((keys[1:] > keys[:-1]).all())


def test_query_rejects_bounds_outside_the_array():
    table = reference.build(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        reference.query(table, torch.tensor([0]), torch.tensor([8]))
    with pytest.raises(ValueError):
        reference.query(table, torch.tensor([3]), torch.tensor([2]))


def test_lower_precisions_lose_information():
    f = torch.tensor([1.0, 1.0 + 2**-10, 0.1], dtype=torch.float32)
    assert reference.lower(f)[0] == reference.lower(f)[1]  # bfloat16 keeps 8 bits
    ints = torch.arange(25, dtype=torch.int32)
    low = reference.lower(ints)
    assert int(low.max()) == 7 and torch.equal(low[:8], ints[:8])  # int4 saturates
    with pytest.raises(TypeError):
        reference.lower(torch.zeros(2, dtype=torch.float64))


def test_compare_counts_wrong_answers_and_malformed_batches():
    ri = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    rv = torch.tensor([0.5, 0.25, 0.0, 1.0])
    assert reference.compare(ri.clone(), rv.clone(), ri, rv) == (0, 0, 0)
    bad_i = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    bad_v = torch.tensor([0.5, 0.25, -0.0, 1.0])  # -0.0 differs bit for bit
    assert reference.compare(bad_i, bad_v, ri, rv) == (1, 1, 2)
    assert reference.compare(ri[:2], rv[:2], ri, rv) == (4, 4, 4)
    assert reference.compare(ri.long(), rv, ri, rv) == (4, 4, 4)
