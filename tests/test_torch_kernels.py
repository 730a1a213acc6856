"""repro_torch kernels and core engines against the JAX reference, on the CPU.

The same numpy input goes through the reference (Pallas kernels in
interpret mode, as the reference's own tests run them off-TPU) and through
the port (whose kernel wrappers run their plain PyTorch versions for CPU
tensors). Tolerance everywhere: exact — indices equal and int32, values
equal and of x's dtype, built structures equal leaf for leaf with dtypes.
Kernel-vs-plain checks on the card are in ``tests/test_torch_cuda.py``.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_rmq as jax_block_rmq
from repro.core import ref
from repro.core import sparse_table as jax_sparse_table
from repro.kernels import ops as jax_ops
from repro.kernels.block_min import block_min as jax_block_min
from repro.kernels.fused_query import fused_query as jax_fused_query
from repro.kernels.fused_query import interior_tables as jax_interior_tables
from repro_torch.core import block_rmq, sparse_table
from repro_torch.kernels import _build, ops, tuning
from repro_torch.kernels.block_min import block_min
from repro_torch.kernels.fused_query import fused_query
from repro_torch.kernels.ref import block_min_ref
from torch_parity_util import assert_same_answer, assert_same_structure, to_np


def _values(rng, n, dtype):
    if dtype == "f32":
        return rng.random(n, dtype=np.float32)
    return rng.integers(0, 3, n).astype(np.int32)  # tie-heavy


def _queries(rng, n, b):
    a = rng.integers(0, n, b)
    c = rng.integers(0, n, b)
    l, r = np.minimum(a, c), np.maximum(a, c)
    mid = n // 2
    l[:3] = [0, mid, n - 1]  # full range and l == r queries
    r[:3] = [n - 1, mid, n - 1]
    return l.astype(np.int32), r.astype(np.int32)


# --- block_min -------------------------------------------------------------


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_block_min_matches_pallas(dtype, bs):
    rng = np.random.default_rng(1)
    nb = 13  # not a multiple of the reference's tile_rows=8
    xb = _values(rng, nb * bs, dtype).reshape(nb, bs)
    want = jax_block_min(jnp.asarray(xb), interpret=True)
    got = block_min(torch.from_numpy(xb))
    assert_same_answer((want[1], want[0]), (got[1], got[0]))
    assert_same_answer((want[1], want[0]), block_min_ref(torch.from_numpy(xb))[::-1])


def test_block_min_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        block_min(torch.zeros((2, 128), dtype=torch.float64))
    with pytest.raises(ValueError):
        block_min(torch.zeros((2, 100)))
    # Neither CPU nor CUDA: no quiet fallback to the plain version.
    with pytest.raises(ValueError):
        block_min(torch.zeros((2, 128), device="meta"))


# --- fused_query -----------------------------------------------------------


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("fetch", ["resident", "dma"])
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_fused_query_matches_pallas(dtype, fetch, tile):
    rng = np.random.default_rng(2)
    bs, nb = 128, 20
    n = bs * nb - 37  # padded last block
    x = _values(rng, n, dtype)
    l, r = _queries(rng, n, 37)  # not a multiple of the tile
    js = jax_block_rmq.build(jnp.asarray(x), bs)
    sv, sg = jax_interior_tables(js.bmin_val, js.bmin_gidx, js.st.idx)
    want = jax_fused_query(
        js.x_blocks, js.bmin_val, js.bmin_gidx, js.st.idx, jnp.asarray(l), jnp.asarray(r),
        st_val=sv, st_gidx=sg, tile=tile, fetch=fetch, interpret=True,
    )
    ps = block_rmq.build(x, bs, device="cpu")
    assert_same_structure(js, ps)
    psv, psg = ops.interior_tables(ps.bmin_val, ps.bmin_gidx, ps.st.idx)
    assert_same_structure((sv, sg), (psv, psg))
    got = fused_query(
        ps.x_blocks, ps.bmin_val, ps.bmin_gidx, ps.st.idx, l, r,
        st_val=psv, st_gidx=psg, tile=tile, fetch=fetch,
    )
    assert_same_answer(want, got, x=x, gold=ref.rmq_ref(x, l, r))


def test_fused_query_checks_its_inputs():
    s = block_rmq.build(np.arange(256, dtype=np.float32), 128, device="cpu")
    args = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, [0], [5])
    with pytest.raises(ValueError):
        fused_query(*args, fetch="everything")
    with pytest.raises(ValueError):  # dma without its tables, derivation forbidden
        fused_query(*args, fetch="dma", materialize_interior=False)
    with pytest.raises(TypeError):
        fused_query(s.x_blocks.double(), *args[1:])
    idx, val = fused_query(*args, fetch="dma", materialize_interior=True)
    assert idx.tolist() == [0] and val.tolist() == [0.0]


def test_fused_dma_past_resident_ceiling():
    """The dma strategy, 8x past the resident ceiling (nb = 2^16), through
    ``fused_query`` with ``fetch="dma"`` and ``"auto"`` (which must pick dma)."""
    bs = 128
    nb = 8 * tuning.RESIDENT_NB_CEILING
    n = nb * bs
    rng = np.random.default_rng(13)
    x = rng.integers(0, 5, n).astype(np.float32)  # dense ties
    s = block_rmq.build(x, bs, device="cpu")
    a = rng.integers(0, n, 24)
    b = rng.integers(0, n, 24)
    l = np.concatenate([np.minimum(a, b), [0, 0, n - 1, 5]])
    r = np.concatenate([np.maximum(a, b), [n - 1, bs, n - 1, n - 5]])
    gold = ref.rmq_ref(x, l, r)
    assert tuning.resolve_fetch("auto", nb) == "dma"
    for fetch in ("dma", "auto"):
        idx, val = fused_query(
            s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, l, r,
            fetch=fetch, materialize_interior=True,
        )
        np.testing.assert_array_equal(to_np(idx), gold)
        np.testing.assert_array_equal(to_np(val), x[gold])


# --- exact_log2, sparse table, blocked structure ---------------------------


def test_exact_log2_sweep_matches_clz():
    """Every power of two +-1 up to 2^31 - 1 against floor(log2) by bit
    length (what the kernel's ``31 - __clz`` computes), and against the
    reference, which is off by one at 2^31 - 1 (its int32 ``1 << 31``
    wraps negative): pinned here as a fault of the reference."""
    lengths = sorted({(1 << p) + d for p in range(32) for d in (-1, 0, 1)} - {0, 2**31, 2**31 + 1})
    lengths = np.array(lengths, np.int64)
    clz = np.array([int(v).bit_length() - 1 for v in lengths], np.int32)
    got = sparse_table.exact_log2(torch.from_numpy(lengths.astype(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), clz)
    want = np.asarray(jax_sparse_table.exact_log2(jnp.asarray(lengths.astype(np.int32))))
    differs = lengths[want != clz]
    assert differs.tolist() == [2**31 - 1] and want[lengths == 2**31 - 1].tolist() == [31]
    ok = lengths != 2**31 - 1
    np.testing.assert_array_equal(to_np(got)[ok], want[ok])


@pytest.mark.parametrize("n", [1, 2, 5, 129, 1000])
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_sparse_table_matches_reference(n, dtype):
    """Leaf-for-leaf table equality, including the ``cur[-1]`` tail clamp of
    every level with ``h < n`` and the repeated levels with ``h >= n``."""
    rng = np.random.default_rng(n)
    x = _values(rng, n, dtype)
    jt = jax_sparse_table.build(jnp.asarray(x))
    pt = sparse_table.build(torch.from_numpy(x))
    assert_same_structure(jt, pt)
    l, r = _queries(rng, n, 40)
    want = jax_sparse_table.query(jt, jnp.asarray(l), jnp.asarray(r))
    got = sparse_table.query(pt, l, r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    np.testing.assert_array_equal(to_np(got), ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_block_rmq_matches_reference(dtype, bs):
    rng = np.random.default_rng(3)
    n = 3 * bs + 77
    x = _values(rng, n, dtype)
    js = jax_block_rmq.build(jnp.asarray(x), bs)
    ps = block_rmq.build(x, bs, device="cpu")
    assert_same_structure(js, ps)
    l, r = _queries(rng, n, 50)
    want = jax_block_rmq.query(js, jnp.asarray(l), jnp.asarray(r))
    assert_same_answer(want, block_rmq.query(ps, l, r), x=x, gold=ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_ops_build_and_query_match_reference(dtype):
    rng = np.random.default_rng(4)
    n = 16 * 128 - 5
    x = _values(rng, n, dtype)
    js = jax_ops.build(jnp.asarray(x), 128, interpret=True)
    ps = ops.build(x, 128, device="cpu")
    assert_same_structure(js, ps)
    l, r = _queries(rng, n, 24)
    for fetch in ("resident", "dma"):
        want = jax_ops.query(js, jnp.asarray(l), jnp.asarray(r), fetch=fetch, interpret=True)
        got = ops.query(ps, l, r, fetch=fetch)
        assert_same_answer(want, got, x=x, gold=ref.rmq_ref(x, l, r))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.query(ps, l, r, fused=False)


# --- no quiet fallback -----------------------------------------------------


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    x = np.arange(256, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.build(x, 128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        block_rmq.build(x, 128)


def test_kernel_loader_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    monkeypatch.setattr(os, "access", lambda *a, **k: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library()
