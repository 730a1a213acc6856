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
from repro.core import lane_rmq as jax_lane_rmq
from repro.core import ref
from repro.core import sparse_table as jax_sparse_table
from repro.kernels import ops as jax_ops
from repro.kernels.block_min import block_min as jax_block_min
from repro.kernels.fused_query import fused_query as jax_fused_query
from repro.kernels.fused_query import fused_query_packed as jax_fused_query_packed
from repro.kernels.fused_query import interior_tables as jax_interior_tables
from repro.kernels.lane_query import lane_partials as jax_lane_partials
from repro.kernels.ref import rmq_partials_ref as jax_rmq_partials_ref
from repro.kernels.rmq_query import rmq_partials as jax_rmq_partials
from repro_torch.core import block_rmq, hybrid, lane_rmq, sparse_table
from repro_torch.kernels import _build, ops, tuning
from repro_torch.kernels.block_min import block_min
from repro_torch.kernels.edge_batch import doubling_edges, edge_batch, maxval_only
from repro_torch.kernels.fused_query import fused_query, fused_query_packed, fused_query_packed_plain
from repro_torch.kernels.lane_query import lane_partials
from repro_torch.kernels.ref import block_min_ref, rmq_partials_ref
from repro_torch.kernels.rmq_query import rmq_partials, rmq_partials_plain
from repro_torch.kernels.sparse_query import sparse_query, sparse_query_plain
from torch_parity_util import assert_same_answer, assert_same_structure, to_np


def _values(rng, n, dtype):
    if dtype == "f32":
        return rng.random(n, dtype=np.float32)
    if dtype == "f32z":  # ties between -0.0 and +0.0, and negatives
        return rng.choice(np.array([-1.5, -0.0, 0.0, 0.0, 2.0], np.float32), n)
    return rng.integers(0, 3, n).astype(np.int32)  # tie-heavy


def _assert_bits(want, got):
    """Output tuples equal with dtypes pinned, values bit for bit (so -0.0
    and +0.0 differ)."""
    for a, b in zip(want, got):
        a, b = np.asarray(a), to_np(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))


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


# --- sparse_query: the doubling-table query of the long path ----------------


def _doubling_values(rng, n, kind):
    """Values of a ``sparse_query`` test: ``_values``' uniform float32, zeros
    of both signs among ties, tie-heavy small integers; or ``f32max`` /
    ``i32max``, maxval (+inf, INT32_MAX) with a few small values, so that
    many ranges hold maxval alone."""
    if kind in ("f32", "f32z", "i32"):
        return _values(rng, n, kind)
    big = np.float32(np.inf) if kind == "f32max" else np.iinfo(np.int32).max
    x = np.full(n, big, np.float32 if kind == "f32max" else np.int32)
    few = rng.random(n) < 0.05
    x[few] = rng.integers(-3, 3, int(few.sum()))
    return x


def _doubling_queries(rng, n, b=64):
    """``doubling_edges(n)``, then random queries up to ``b`` in all."""
    el, er = doubling_edges(n)
    l, r = _queries(rng, n, b - el.size)
    return np.concatenate([el, l]), np.concatenate([er, r])


@pytest.mark.parametrize("n", [1, 2, 5, 129, 1000])
@pytest.mark.parametrize("kind", ["f32", "f32z", "i32", "f32max", "i32max"])
def test_sparse_query_matches_plain_and_reference(n, kind):
    """On CPU tensors ``sparse_query`` is ``sparse_table.query`` then
    ``x[idx]``, bit for bit, and its indices are the reference's and the
    oracle's: lengths 1, n and 2^k +- 1 from either end, (0, 0) pads, ties
    (the leftmost wins), zeros of both signs and maxval-only ranges."""
    rng = np.random.default_rng(n)
    x = _doubling_values(rng, n, kind)
    l, r = _doubling_queries(rng, n)
    xt, lt, rt = torch.from_numpy(x), torch.from_numpy(l), torch.from_numpy(r)
    st = sparse_table.build(xt)
    got = sparse_query(st.idx, xt, lt, rt)
    idx = to_np(sparse_table.query(st, lt, rt))
    _assert_bits((idx, x[idx]), got)
    _assert_bits((idx, x[idx]), sparse_query_plain(st.idx, xt, lt, rt))
    want = jax_sparse_table.query(jax_sparse_table.build(jnp.asarray(x)), jnp.asarray(l), jnp.asarray(r))
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(want))
    np.testing.assert_array_equal(to_np(got[0]), ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("kind", ["f32z", "i32max"])
def test_hybrid_with_use_kernels_answers_as_without(kind, monkeypatch):
    """``hybrid.assemble(use_kernels=True)`` sends the long path through
    ``ops.sparse_query`` (its plain version on the CPU) and answers mixed
    batches as the torch-op path does, bit for bit."""
    rng = np.random.default_rng(11)
    n = 3000
    x = _doubling_values(rng, n, kind)
    l, r = _doubling_queries(rng, n, 400)
    calls = []
    real = ops.sparse_query
    monkeypatch.setattr(ops, "sparse_query", lambda *a, **k: calls.append(a[2].numel()) or real(*a, **k))
    plain = hybrid.build(x, threshold=40, use_kernels=False, device="cpu")
    kern = hybrid.build(x, threshold=40, use_kernels=True, device="cpu")
    assert kern.use_kernels and not plain.use_kernels
    want = [to_np(a) for a in hybrid.query(plain, l, r)]
    assert not calls
    _assert_bits(want, hybrid.query(kern, l, r))
    n_long = int(((r.astype(np.int64) - l + 1) > 40).sum())
    assert 0 < n_long < l.size and calls == [1 << (n_long - 1).bit_length()]


def _sparse_query_case(case):
    x = torch.arange(8, dtype=torch.float32)
    t = sparse_table.build(x).idx
    l = torch.tensor([0, 2], dtype=torch.int32)
    r = torch.tensor([7, 5], dtype=torch.int32)
    if case == "table int64":
        t = t.long()
    elif case == "table 1-D":
        t = t[0]
    elif case == "table too few levels":
        t = t[:2].contiguous()
    elif case == "table of another n":
        t = sparse_table.build(torch.arange(9, dtype=torch.float32)).idx
    elif case == "table not contiguous":
        t = t.t().contiguous().t()
    elif case == "x float64":
        x = x.double()
    elif case == "x 2-D":
        x = x[None]
    elif case == "l 2-D":
        l = l[None]
    elif case == "l int64":
        l = l.long()
    elif case == "l a list":
        l = [0, 2]
    elif case == "unequal shapes":
        r = r[:1]
    elif case == "device mismatch":
        x = x.to("meta")
    return t, x, l, r


@pytest.mark.parametrize(
    "case",
    [
        "table int64", "table 1-D", "table too few levels", "table of another n",
        "table not contiguous", "x float64", "x 2-D", "l 2-D", "l int64", "l a list",
        "unequal shapes", "device mismatch",
    ],
)
def test_sparse_query_rejects_what_the_kernel_does_not_take(case):
    """The checks come before the CPU branch, so a CPU call raises on every
    input the kernel would not take; there is no quiet fallback."""
    with pytest.raises((ValueError, TypeError)):
        sparse_query(*_sparse_query_case(case))
    idx, val = sparse_query(*_sparse_query_case("none"))
    assert idx.tolist() == [0, 2] and val.tolist() == [0.0, 2.0]


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
    # The two-pass path: the rmq_partials kernel (its plain version here),
    # then the interior and merge in PyTorch.
    want = jax_ops.query(js, jnp.asarray(l), jnp.asarray(r), fused=False, interpret=True)
    got = ops.query(ps, l, r, fused=False)
    assert_same_answer(want, got, x=x, gold=ref.rmq_ref(x, l, r))
    _assert_bits(want, got)


# --- signed zeros: the reference kernels' ``jnp.min`` --------------------------


def test_signed_zero_minimum_matches_pallas():
    """A row whose minimum is a zero of both signs: the reference kernels
    take ``vmin = jnp.min(row)``, which is -0.0, and the leftmost lane equal
    to it; ``block_min`` and ``fused_query`` give the same bits (ROADMAP.md,
    faults found in the port)."""
    bs, nb = 128, 12
    rng = np.random.default_rng(9)
    x = _values(rng, nb * bs - 5, "f32z")
    x[:bs] = 1.0
    x[:2] = [0.0, -0.0]  # the smallest case: block 0 = [+0.0, -0.0, 1.0, ...]
    xb = block_rmq.pad_blocks(torch.from_numpy(x), bs)
    want = jax_block_min(jnp.asarray(to_np(xb)), interpret=True)
    got = block_min(xb)
    _assert_bits(want, got)
    assert to_np(got[0])[0].view(np.int32) == np.float32(-0.0).view(np.int32)
    assert int(got[1][0]) == 0  # the leftmost zero, though it is +0.0
    js = jax_ops.build(jnp.asarray(x), bs, interpret=True)
    ps = ops.build(x, bs, device="cpu")
    _assert_bits((js.bmin_val, js.bmin_gidx), (ps.bmin_val, ps.bmin_gidx))
    l, r = _queries(rng, x.size, 37)
    for fetch in ("resident", "dma"):
        want = jax_ops.query(js, jnp.asarray(l), jnp.asarray(r), fetch=fetch, interpret=True)
        _assert_bits(want, ops.query(ps, l, r, fetch=fetch))


# --- rmq_partials ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32z", "i32"])
def test_rmq_partials_matches_pallas(dtype):
    """The wrapper's plain version against the Pallas kernel in interpret
    mode (bits, -0.0 included), and the port's ``rmq_partials_ref`` against
    the reference's (argmin-based: the leftmost element's bits)."""
    rng = np.random.default_rng(12)
    bs, nb = 128, 20
    n = bs * nb - 37
    x = _values(rng, n, dtype)
    l, r = _queries(rng, n, 37)
    xb = block_rmq.pad_blocks(torch.from_numpy(x), bs)
    bl, br = l // bs, r // bs
    ls, rl = l - bl * bs, r - br * bs
    le = np.where(bl == br, rl, bs - 1)
    args = [a.astype(np.int32) for a in (bl, br, ls, le, rl)]
    jargs = [jnp.asarray(a) for a in args]
    jxb = jnp.asarray(to_np(xb))
    want = jax_rmq_partials(jxb, *jargs, tile=8, interpret=True)
    got = rmq_partials(xb, *args, tile=8)
    assert got[1].dtype == torch.int32
    _assert_bits(want, got)
    _assert_bits(got, rmq_partials_plain(xb, *(torch.from_numpy(a) for a in args)))
    _assert_bits(
        jax_rmq_partials_ref(jxb, *jargs), rmq_partials_ref(xb, *(torch.from_numpy(a) for a in args))
    )
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no quiet fallback
        rmq_partials(xb.to("meta"), *args)


# --- fused_query_packed ----------------------------------------------------


@pytest.mark.parametrize(
    "layout,fetch,dtype",
    [
        ("packed32", "resident", "i32"),
        ("packed32", "dma", "i32"),
        ("quantized", "resident", "f32z"),
        ("quantized", "resident", "i32"),
    ],
)
def test_fused_query_packed_matches_pallas(layout, fetch, dtype):
    """The packed megakernel's plain version against the Pallas kernel in
    interpret mode, same structure (leaf for leaf) and same bits."""
    rng = np.random.default_rng(14)
    bs, nb = 128, 20
    n = bs * nb - 37
    x = _values(rng, n, dtype)
    l, r = _queries(rng, n, 37)
    js, jspec = jax_ops.build_packed(jnp.asarray(x), bs, layout=layout)
    ps, spec = ops.build_packed(x, bs, layout=layout, device="cpu")
    assert spec == jspec
    assert_same_structure(js, ps)
    want = jax_fused_query_packed(
        js.blocks, js.stw, jnp.asarray(l), jnp.asarray(r), spec=jspec, bmin_val=js.bmin_val,
        tile=8, fetch=fetch, interpret=True,
    )
    got = fused_query_packed(ps.blocks, ps.stw, l, r, spec=spec, bmin_val=ps.bmin_val, fetch=fetch)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.from_numpy(x).dtype
    _assert_bits(want, got)
    np.testing.assert_array_equal(to_np(got[0]), ref.rmq_ref(x, l, r))
    lt, rt = torch.from_numpy(l), torch.from_numpy(r)
    _assert_bits(got, fused_query_packed_plain(ps.blocks, ps.stw, lt, rt, spec=spec, bmin_val=ps.bmin_val))


def test_fused_query_packed_checks_its_inputs():
    x = np.arange(300, dtype=np.int32)
    s64, spec64 = ops.build_packed(x, 128, layout="packed64", device="cpu")
    got = fused_query_packed(s64.blocks, s64.stw, [0, 7], [5, 290], spec=spec64)
    lt, rt = torch.tensor([0, 7], dtype=torch.int32), torch.tensor([5, 290], dtype=torch.int32)
    _assert_bits(got, fused_query_packed_plain(s64.blocks, s64.stw, lt, rt, spec=spec64))
    assert got[0].tolist() == [0, 7] and got[1].dtype == torch.int32
    sq, specq = ops.build_packed(x, 128, layout="quantized", device="cpu")
    with pytest.raises(ValueError, match="bmin_val"):
        fused_query_packed(sq.blocks, sq.stw, [0], [5], spec=specq)
    s32, spec32 = ops.build_packed(x, 128, layout="packed32", device="cpu")
    with pytest.raises(ValueError):
        fused_query_packed(s32.blocks, s32.stw, [0], [5], spec=spec32, fetch="everything")
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no quiet fallback
        fused_query_packed(s32.blocks.to("meta"), s32.stw.to("meta"), [0], [5], spec=spec32)
    idx, val = fused_query_packed(s32.blocks, s32.stw, [3], [290], spec=spec32)
    assert idx.tolist() == [3] and val.dtype == torch.int32 and val.tolist() == [3]


# --- the fused body's load scheme: edge_batch ----------------------------------


@pytest.mark.parametrize("b", [1, 4099])
@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize(
    "kernel", ["resident", "dma", "quantized", "rmq_partials", "packed32", "lane_partials"]
)
def test_edge_batch_matches_pallas(kernel, dtype, bs, b):
    """The kernels whose rows the CUDA kernels read in 16-byte pieces, against
    the Pallas kernels in interpret mode on ``edge_batch`` (ranges cut at
    4j, 4j+3 and mid-piece; minima tied across rows, neighbouring lanes and
    pieces; zeros of both signs; maxval minima; bucket collisions): same
    bits, -0.0 included. packed32 takes the batch's small-span values (its
    key span must fit the word) and both fetches. Every answer is the
    oracle's. The carve-out: a query whose range holds only maxval is held
    to the oracle instead of Pallas, which answers some of them with a
    masked lane left of the range (ROADMAP.md §3, a deliberate divergence);
    the test asserts that Pallas still does, so it fails if the reference
    changes."""
    x, l, r = edge_batch(
        bs, dtype, b, finite=kernel == "quantized", small_span=kernel == "packed32"
    )
    jl, jr = jnp.asarray(l), jnp.asarray(r)
    if kernel == "lane_partials":  # 128-wide lane blocks, whatever bs
        js = jax_lane_rmq.build(jnp.asarray(x))
        ps = lane_rmq.build(x, device="cpu")
        sl, sr = l // 128, r // 128
        args = [a.astype(np.int32) for a in (sl, sr, l - sl * 128, r - sr * 128)]
        jplanes = (js.xs, js.suff_val, js.suff_idx, js.pref_val, js.pref_idx)
        want = jax_lane_partials(*jplanes, *map(jnp.asarray, args), tile=8, interpret=True)
        planes = (ps.xs, ps.suff_val, ps.suff_idx, ps.pref_val, ps.pref_idx)
        # lane_partials returns (val, idx); the check takes (idx, val).
        got = lane_partials(*planes, *args)
        return _check_edge(x, l, r, want[::-1], got[::-1], unit=128, lane=True, final=False)
    if kernel == "rmq_partials":
        xb = block_rmq.pad_blocks(torch.from_numpy(x), bs)
        bl, br = l // bs, r // bs
        ls, re = l - bl * bs, r - br * bs
        args = [a.astype(np.int32) for a in (bl, br, ls, np.where(bl == br, re, bs - 1), re)]
        want = jax_rmq_partials(jnp.asarray(to_np(xb)), *map(jnp.asarray, args), tile=8, interpret=True)
        got = rmq_partials(xb, *args, tile=8)
        return _check_edge(x, l, r, want[::-1], got[::-1], unit=bs, final=False)
    if kernel == "packed32":
        js, jspec = jax_ops.build_packed(jnp.asarray(x), bs, layout="packed32")
        ps, spec = ops.build_packed(x, bs, layout="packed32", device="cpu")
        assert spec == jspec
        for fetch in ("resident", "dma"):
            want = jax_fused_query_packed(
                js.blocks, js.stw, jl, jr, spec=jspec, tile=8, fetch=fetch, interpret=True
            )
            got = fused_query_packed(ps.blocks, ps.stw, l, r, spec=spec, fetch=fetch)
            _check_edge(x, l, r, want, got)  # small-span values: no maxval range
        return
    if kernel == "quantized":
        js, jspec = jax_ops.build_packed(jnp.asarray(x), bs, layout="quantized")
        ps, spec = ops.build_packed(x, bs, layout="quantized", device="cpu")
        want = jax_fused_query_packed(
            js.blocks, js.stw, jl, jr, spec=jspec, bmin_val=js.bmin_val, tile=8, interpret=True
        )
        got = fused_query_packed(ps.blocks, ps.stw, l, r, spec=spec, bmin_val=ps.bmin_val)
    else:
        js = jax_ops.build(jnp.asarray(x), bs, interpret=True)
        want = jax_fused_query(
            js.x_blocks, js.bmin_val, js.bmin_gidx, js.st.idx, jl, jr,
            st_val=js.st_val, st_gidx=js.st_gidx, fetch=kernel, interpret=True,
        )
        ps = ops.build(x, bs, device="cpu")
        assert_same_structure(js, ps)
        got = fused_query(
            ps.x_blocks, ps.bmin_val, ps.bmin_gidx, ps.st.idx, l, r,
            st_val=ps.st_val, st_gidx=ps.st_gidx, fetch=kernel,
        )
    _check_edge(x, l, r, want, got, unit=bs)


def _check_edge(x, l, r, want, got, *, unit=None, lane=False, final=True):
    """``got`` (idx, val) bit-identical to the Pallas kernel's ``want`` on
    every query of ``edge_batch`` but the maxval-only ones, which answer the
    oracle's index and value. Pallas answers such a query outside its range
    exactly where a masked lane lies left of it in the row it scans: the
    range starts past its row's first lane (``unit`` is the row width:
    ``bs``, or 128 for the lane kernel, where only a query inside one row
    scans one: ``lane``). ``final``: the output is the whole query's answer, so every
    index is the oracle's (the partial kernels leave the interior out)."""
    gold = ref.rmq_ref(x, l, r)
    carve = maxval_only(x, l, r)
    _assert_bits([np.asarray(a)[~carve] for a in want], [to_np(a)[~carve] for a in got])
    gi, gv = to_np(got[0]), to_np(got[1])
    assert gi.dtype == np.int32 and gv.dtype == x.dtype
    np.testing.assert_array_equal(gi[carve], gold[carve])
    np.testing.assert_array_equal(gv[carve].view(np.int32), x[gold[carve]].view(np.int32))
    wi = np.asarray(want[0])
    faulty = carve & ((wi < l) | (wi > r))
    expect = carve & (l % unit != 0) if unit else np.zeros_like(carve)
    if lane:
        expect &= l // unit == r // unit
    np.testing.assert_array_equal(faulty, expect)
    if final:
        np.testing.assert_array_equal(gi, gold)


@pytest.mark.parametrize("fetch", ["resident", "dma"])
def test_interior_zero_sign_matches_pallas(fetch):
    """The smallest input of a fault of the port (ROADMAP.md §3): interior
    blocks 1..3 with a +0.0 in block 1 and a -0.0 in block 3, so the lo cell
    (blocks 1-2) holds +0.0 and the hi cell (blocks 2-3) -0.0. The reference
    takes ``jnp.minimum`` of the two cells, -0.0, with the lo cell's index;
    the port took the lo cell's +0.0."""
    bs = 128
    x = np.ones(5 * bs, np.float32)
    x[bs], x[3 * bs] = 0.0, -0.0
    js = jax_ops.build(jnp.asarray(x), bs, interpret=True)
    want = jax_ops.query(js, jnp.asarray([0]), jnp.asarray([x.size - 1]), fetch=fetch, interpret=True)
    got = ops.query(ops.build(x, bs, device="cpu"), [0], [x.size - 1], fetch=fetch)
    _assert_bits(want, got)
    assert int(got[0][0]) == bs and to_np(got[1]).view(np.int32)[0] == np.int32(-(2**31))


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
