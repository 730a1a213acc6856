"""packed64 on the port's short path, on the CPU, against the benchmark's
plain reference (``bench/reference.py``: exact leftmost argmin and its
value, from a doubling table of (value, index) keys it builds itself).

The CUDA body of ``fused_query_packed`` runs only on a card
(``tests/test_torch_cuda.py``); here its plain mirror
(``fused_query_packed_plain``, which ``fused_query_packed`` runs for CPU
tensors) and ``packed_hybrid`` with ``packed="packed64"`` are held to the
reference on seeded float32 and int32 data with ties, signed zeros, block
edges and ranges of 1, threshold - 1, threshold and threshold + 1 cells.
Indices are compared exactly, values bit for bit; the packed layouts fold
-0.0 to +0.0 (``core.packing``), so a float32 reference value is compared
as ``v + 0.0``. Also: ``hybrid.assemble``'s ``use_kernels`` on packed64
parts. Imports no JAX.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import block_rmq, hybrid, sparse_table
from repro_torch.core import build as build_mod
from repro_torch.kernels import ops
from repro_torch.kernels.fused_query import fused_query_packed, fused_query_packed_plain

_spec = importlib.util.spec_from_file_location(
    "_bench_reference_packed64", Path(__file__).resolve().parents[1] / "bench" / "reference.py"
)
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)

N = 4096 + 37  # 32 whole blocks of 128 and a partial one; sqrt(n) = 64
THRESHOLD = 64


def _values(dtype: str, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype == "f32":  # ties between -0.0 and +0.0, negatives, infinities
        pool = np.array([-1.5, -0.0, 0.0, 0.25, 2.0, np.inf, -np.inf], np.float32)
        x = rng.choice(pool, N, p=[0.1, 0.2, 0.2, 0.2, 0.2, 0.05, 0.05])
    else:  # few values, and both ends of int32
        x = rng.integers(-3, 3, N).astype(np.int32)
        x[rng.integers(0, N, 16)] = np.iinfo(np.int32).min
        x[rng.integers(0, N, 16)] = np.iinfo(np.int32).max
    return torch.from_numpy(x)


def _bounds(seed: int):
    """Random ranges of every length class the hybrid routes, and the edges:
    ranges starting and ending at block boundaries, whole blocks, one cell."""
    rng = np.random.default_rng(seed)
    lengths = [1, THRESHOLD - 1, THRESHOLD, THRESHOLD + 1, 127, 128, 129, 256, 300, N]
    l, r = [], []
    for length in lengths:
        starts = rng.integers(0, N - length + 1, 40)
        l += starts.tolist()
        r += (starts + length - 1).tolist()
    for edge in (0, 127, 128, 255, 256, N - 38, N - 37, N - 1):  # block edges
        for length in (1, 2, THRESHOLD - 1, 130):
            if edge + length <= N:
                l.append(edge)
                r.append(edge + length - 1)
            if edge - length + 1 >= 0:
                l.append(edge - length + 1)
                r.append(edge)
    return torch.tensor(l, dtype=torch.int32), torch.tensor(r, dtype=torch.int32)


def _assert_as_reference(x, l, r, got):
    idx, val = got
    ref_idx, ref_val = reference.query(reference.build(x), l, r)
    assert idx.dtype == torch.int32 and val.dtype == x.dtype
    assert torch.equal(idx, ref_idx)
    if x.dtype == torch.float32:
        val, ref_val = val.view(torch.int32), (ref_val + 0.0).view(torch.int32)
    assert torch.equal(val, ref_val)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_packed64_plain_mirror_matches_reference(dtype, seed):
    """The kernel's plain mirror and the wrapper's CPU path, packed64 words."""
    x = _values(dtype, seed)
    l, r = _bounds(seed + 10)
    s, spec = ops.build_packed(x, 128, layout="packed64", device="cpu")
    assert spec.layout == "packed64" and s.blocks.dtype == s.stw.dtype == torch.int64
    plain = fused_query_packed_plain(s.blocks, s.stw, l, r, spec=spec)
    _assert_as_reference(x, l, r, plain)
    for fetch in ("resident", "dma"):
        got = fused_query_packed(s.blocks, s.stw, l, r, spec=spec, fetch=fetch)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, plain))
    want = block_rmq.query_packed(s, spec, l, r)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(want, plain))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_packed_hybrid_packed64_matches_reference(dtype, use_kernels):
    """The registry's packed hybrid with packed64 pinned, both paths routed,
    with the plain short path and with the kernel's (its plain mirror on the
    CPU)."""
    x = _values(dtype, 2)
    l, r = _bounds(12)
    s = build_mod.build("hybrid", x, device="cpu", packed="packed64", use_kernels=use_kernels)
    assert s.spec.layout == "packed64" and s.threshold == THRESHOLD
    assert s.use_kernels is use_kernels
    splits = []
    with hybrid.record_splits(lambda n_short, n_long: splits.append((n_short, n_long))):
        got = hybrid.query(s, l, r)
    (n_short, n_long), = splits
    assert n_short > 0 and n_long > 0
    _assert_as_reference(x, l, r, got)


def test_assemble_sets_use_kernels_only_where_a_kernel_serves():
    """``use_kernels`` reads True where asked for, since a kernel serves
    every packed layout (packed64 too), and False otherwise; both short
    paths answer as the reference does."""
    x = _values("f32", 3)
    blocked, spec = ops.build_packed(x, 128, layout="packed64", device="cpu")
    st, _ = sparse_table.build_packed(x, spec=spec)
    l, r = _bounds(13)
    for use_kernels in (True, False):
        s = hybrid.assemble(blocked, st, x, THRESHOLD, use_kernels, spec=spec)
        assert s.use_kernels is use_kernels
        _assert_as_reference(x, l, r, hybrid.query(s, l, r))
