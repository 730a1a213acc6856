"""repro_torch packed (value, index) words against the JAX reference, on the CPU.

The single-host encoding properties of ``tests/test_packing.py`` run on the
port's ``core.packing`` beside ``repro.core.packing`` on the same numpy
inputs; the packed builds (``sparse_table``, ``block_rmq``, ``ops``) must
equal the reference's leaf for leaf with dtypes (words int32, or int64 for
packed64), and every packed query must give the reference's indices (int32)
and value bits — a float -0.0 comes back as +0.0 from the exact layouts,
whose values decode from the key. Tolerance: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import block_rmq as jax_block_rmq
from repro.core import hybrid as jax_hybrid
from repro.core import packing as jax_packing
from repro.core import ref
from repro.core import sparse_table as jax_sparse_table
from repro.kernels import ops as jax_ops
from repro_torch.core import block_rmq, hybrid, packing, sparse_table
from repro_torch.kernels import ops
from torch_parity_util import assert_same_structure, to_np


def _random_ranges(rng, n: int, m: int):
    l = rng.integers(0, n, m)
    r = rng.integers(0, n, m)
    return np.minimum(l, r), np.maximum(l, r)


def assert_same_bits(ref_out, port_out, x):
    """(idx, val) equal with dtypes pinned: idx int32, val of x's dtype, the
    values compared bit for bit (so -0.0 and +0.0 differ)."""
    ri, rv = (np.asarray(a) for a in ref_out)
    pi, pv = (to_np(a) for a in port_out)
    assert ri.dtype == pi.dtype == np.int32, (ri.dtype, pi.dtype)
    assert rv.dtype == pv.dtype == np.asarray(x).dtype, (rv.dtype, pv.dtype)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv.view(np.int32), rv.view(np.int32))


def _signed_zeros(rng, n):
    """Float data with ties, negatives and both zeros (-0.0 and +0.0)."""
    x = rng.choice(np.array([-2.5, -0.0, 0.0, 0.5, 3.75], np.float32), n)
    x[rng.integers(0, n, n // 8)] = rng.random(n // 8, dtype=np.float32)
    return x


# --- encoding properties (tests/test_packing.py:56-144) ------------------------


@pytest.mark.parametrize("layout", ["packed64", "packed32"])
@pytest.mark.parametrize("data", ["float_dupes", "int_extremes", "all_equal", "descending", "single"])
def test_word_min_is_exact_leftmost_argmin(layout, data):
    """min over packed words == the leftmost exact argmin (as in the
    reference test), and the port's spec and words equal the reference's."""
    rng = np.random.default_rng(3)
    if data == "float_dupes":
        x = rng.choice(np.array([-2.5, -1.0, 0.5, 3.75], np.float32), 257)
    elif data == "int_extremes":
        x = rng.integers(-1000, 1000, 256).astype(np.int32)
        x[17] = -1000
        x[200] = -1000  # duplicated min: leftmost must win
    elif data == "all_equal":
        x = np.full(64, -7.0, np.float32)
    elif data == "descending":
        x = np.arange(100, 0, -1).astype(np.float32)
    else:
        x = np.array([42.0], np.float32)
    n = x.shape[0]
    try:
        jspec = jax_packing.spec_for(jnp.asarray(x), n, layout)
    except ValueError:  # float keys that span the bitcast range: packed32 misfits
        with pytest.raises(ValueError):
            packing.spec_for(x, n, layout)
        return
    spec = packing.spec_for(x, n, layout)
    assert spec == jspec
    words = packing.pack_np(spec, x, np.arange(n, dtype=np.int32))
    np.testing.assert_array_equal(words, jax_packing.pack_np(spec, x, np.arange(n, dtype=np.int32)))
    tw = packing.pack(spec, torch.from_numpy(x), torch.arange(n, dtype=torch.int32))
    assert tw.dtype == packing.word_dtype(spec) and to_np(tw).dtype == packing.word_dtype_np(spec)
    np.testing.assert_array_equal(to_np(tw), words)
    for _ in range(50):
        a, b = sorted(rng.integers(0, n, 2))
        w = words[a : b + 1].min()
        want = a + int(np.argmin(x[a : b + 1]))
        assert packing.unpack_idx_np(spec, np.array([w]))[0] == want
        assert packing.unpack_val_np(spec, np.array([w]))[0] == x[want]
        tw_min = tw[a : b + 1].min().reshape(1)
        assert packing.unpack_idx(spec, tw_min).tolist() == [want]
        assert packing.unpack_val(spec, tw_min).tolist() == [x[want]]


def test_int32_min_max_keys_roundtrip():
    """The full int32 key range survives pack/unpack exactly (packed64)."""
    x = np.array([np.iinfo(np.int32).min, 0, np.iinfo(np.int32).max], np.int32)
    spec = packing.spec_for(x, 3, "packed64")
    w = packing.pack(spec, torch.from_numpy(x), torch.arange(3, dtype=torch.int32))
    assert w.dtype == torch.int64
    assert packing.unpack_val(spec, w).tolist() == list(x)
    assert packing.unpack_idx(spec, w).dtype == torch.int32
    assert packing.unpack_idx(spec, w).tolist() == [0, 1, 2]
    assert w[0] == w.min()  # int32 min is the smallest key
    np.testing.assert_array_equal(to_np(w), jax_packing.pack_np(spec, x, np.arange(3, dtype=np.int32)))


def test_pad_word_never_wins():
    """pad_word is the word-domain maximum: a real word always beats it."""
    x = np.array([np.iinfo(np.int32).max], np.int32)
    for layout in ("packed64", "packed32"):
        spec = packing.spec_for(x, 128, layout)
        assert packing.pad_word(spec) == jax_packing.pad_word(spec)
        assert packing.word_nbytes(spec) == jax_packing.word_nbytes(spec)
        w = packing.pack(spec, torch.from_numpy(x), torch.zeros(1, dtype=torch.int32))
        assert int(w[0]) < packing.pad_word(spec)


def test_packed32_misfit_is_loud():
    """A key range packed32 cannot hold raises at spec time (explicit
    layout) and at numpy pack time — never a silent wrong encoding."""
    with pytest.raises(ValueError):
        packing.spec_for(np.array([-(2**30), 2**30], np.int32), 2, "packed32")
    spec = packing.spec_for(np.array([5, 9, 7], np.int32), 3, "packed32")
    with pytest.raises(OverflowError):
        packing.pack_np(spec, np.array([np.iinfo(np.int32).max], np.int32), np.zeros(1, np.int32))


def test_spec_for_auto_resolution_and_meta_round_trip():
    """auto -> packed32 when the key span fits, else packed64; the spec is
    the reference's and its meta round-trips through either package."""
    narrow = np.arange(100, dtype=np.int32)
    s1 = packing.spec_for(torch.from_numpy(narrow), 100, "auto")
    assert s1.layout == "packed32" and s1 == packing.spec_for(narrow, 100, "auto")
    floats = np.random.default_rng(0).standard_normal(100).astype(np.float32)
    assert packing.spec_for(floats, 100, "auto").layout == "packed64"
    for x in (narrow, floats):
        for layout in ("auto", "packed64", "quantized"):
            spec = packing.spec_for(x, 100, layout)
            jspec = jax_packing.spec_for(jnp.asarray(x), 100, layout)
            assert tuple(spec) == tuple(jspec) and spec._fields == jspec._fields
            assert packing.PackSpec.from_meta(jspec.to_meta()) == spec
            assert jax_packing.PackSpec.from_meta(spec.to_meta()) == jspec
    assert packing.LAYOUTS == jax_packing.LAYOUTS
    assert packing.PACKED_LAYOUTS == jax_packing.PACKED_LAYOUTS
    for n_index in (1, 2, 3, 128, 1000, 1 << 26):
        assert packing.idx_bits_for(n_index) == jax_packing.idx_bits_for(n_index)


@pytest.mark.parametrize("val_bits", [5, 16])
def test_quantized_buckets_match_reference(val_bits):
    """Bucket codes in float32 with float32 scalars, at a narrow grid (5
    bits, as at n = 2^26) and the widest (16 bits): the port's torch and
    numpy twins equal the reference's, and -0.0 buckets like +0.0."""
    rng = np.random.default_rng(val_bits)
    x = (rng.standard_normal(4096) * 1000).astype(np.float32)
    x[:4] = [-0.0, 0.0, x.min(), x.max()]
    bits = 31 - val_bits
    spec = packing.spec_for(x, 1 << bits, "quantized")
    assert spec.val_bits == val_bits and spec == jax_packing.spec_for(jnp.asarray(x), 1 << bits, "quantized")
    want = np.asarray(jax_packing.pack(spec, jnp.asarray(x), jnp.arange(4096, dtype=jnp.int32)))
    got = packing.pack(spec, torch.from_numpy(x), torch.arange(4096, dtype=torch.int32))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(packing.pack_np(spec, x, np.arange(4096)), want)
    assert int(got[0]) >> bits == int(got[1]) >> bits


def test_negative_zero_packs_as_positive_zero():
    x = np.array([-0.0, 0.0, -1.5], np.float32)
    spec = packing.spec_for(x, 3, "packed64")
    w = packing.pack(spec, torch.from_numpy(x), torch.arange(3, dtype=torch.int32))
    np.testing.assert_array_equal(to_np(w), np.asarray(jax_packing.pack(spec, jnp.asarray(x), jnp.arange(3, dtype=jnp.int32))))
    assert int(w[0]) >> 32 == int(w[1]) >> 32  # the two zeros share one key
    back = to_np(packing.unpack_val(spec, w))
    assert back.view(np.int32).tolist()[:2] == [0, 0]  # both decode to +0.0


def test_quantized_bucket_collisions_resolve_exactly():
    """Values far closer than a bucket width, many collisions across block
    boundaries: the exact fallback answers as the unpacked oracle does, in
    the port's plain and kernel-path (plain version) hybrids alike."""
    rng = np.random.default_rng(11)
    n = 1 << 10
    x = (np.repeat(np.linspace(0, 1000, 8), n // 8) + rng.random(n) * 1e-4).astype(np.float32)
    l, r = _random_ranges(rng, n, 256)
    gold = ref.rmq_ref(x, l, r)
    js = jax_hybrid.build(jnp.asarray(x), 128, packed="quantized", use_kernels=False)
    want = jax_hybrid.query(js, l, r)
    for use_kernels in (False, True):
        ps = hybrid.build(x, 128, packed="quantized", use_kernels=use_kernels, device="cpu")
        got = hybrid.query(ps, l, r)
        assert_same_bits(want, got, x)
        np.testing.assert_array_equal(to_np(got[0]), gold)


# --- packed structures leaf for leaf -------------------------------------------


_CASES = [
    ("packed64", "f32"),
    ("packed64", "i32"),
    ("packed32", "i32"),
    ("quantized", "f32"),
    ("quantized", "i32"),
    ("auto", "f32"),
    ("auto", "i32"),
]


def _data(rng, n, kind):
    if kind == "f32":
        return _signed_zeros(rng, n)
    return rng.integers(-40, 40, n).astype(np.int32)


@pytest.mark.parametrize("layout,kind", _CASES)
def test_sparse_table_packed_matches_reference(layout, kind):
    rng = np.random.default_rng(21)
    n = 1000
    x = _data(rng, n, kind)
    jt, jspec = jax_sparse_table.build_packed(jnp.asarray(x), layout=layout)
    pt, pspec = sparse_table.build_packed(torch.from_numpy(x), layout=layout)
    assert pspec == jspec
    assert_same_structure(jt, pt)
    assert to_np(pt.words).dtype == np.asarray(jt.words).dtype == packing.word_dtype_np(pspec)
    l, r = _random_ranges(rng, n, 64)
    want = jax_sparse_table.query_packed(jt, jspec, jnp.asarray(l), jnp.asarray(r))
    got = sparse_table.query_packed(pt, pspec, l, r)
    assert_same_bits(want, got, x)
    np.testing.assert_array_equal(to_np(got[0]), ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("bs", [128, 256])
@pytest.mark.parametrize("layout,kind", _CASES)
def test_block_rmq_packed_matches_reference(layout, kind, bs):
    rng = np.random.default_rng(22)
    n = 5 * bs + 37  # a padded last block
    x = _data(rng, n, kind)
    js, jspec = jax_block_rmq.build_packed(jnp.asarray(x), bs, layout=layout)
    ps, pspec = block_rmq.build_packed(x, bs, layout=layout, device="cpu")
    assert pspec == jspec
    assert_same_structure(js, ps)
    l, r = _random_ranges(rng, n, 64)
    l[:2], r[:2] = [0, n - 1], [n - 1, n - 1]
    want = jax_block_rmq.query_packed(js, jspec, jnp.asarray(l), jnp.asarray(r))
    got = block_rmq.query_packed(ps, pspec, l, r)
    assert_same_bits(want, got, x)
    np.testing.assert_array_equal(to_np(got[0]), ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("layout,kind", [c for c in _CASES if c[0] != "packed64"])
def test_ops_build_packed_matches_reference(layout, kind):
    """The kernel state, leaf for leaf (quantized keeps its bmin_val plane,
    -0.0 below +0.0 as the reference's ``jnp.min`` orders it)."""
    rng = np.random.default_rng(23)
    n = 9 * 128 - 11
    x = _data(rng, n, kind)
    js, jspec = jax_ops.build_packed(jnp.asarray(x), 128, layout=layout)
    ps, pspec = ops.build_packed(x, 128, layout=layout, device="cpu")
    assert pspec == jspec
    assert_same_structure(js, ps)
    if pspec.layout == "quantized" and kind == "f32":
        want = np.asarray(js.bmin_val)
        np.testing.assert_array_equal(to_np(ps.bmin_val).view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("packed", [None, "auto", "packed64", "quantized"])
@pytest.mark.parametrize("engine", ["sparse_table", "block128", "fused128", "hybrid", "packed_hybrid"])
def test_packed_spec_reads_the_resolved_layout(engine, packed):
    """``registry.packed_spec`` finds the PackSpec a served build resolved to
    (None when unpacked): float data under ``auto`` resolves to packed64, as
    in the reference; fused128 refuses an explicit packed64 at plan time."""
    from repro_torch.core import registry

    x = np.random.default_rng(3).random(1 << 10, dtype=np.float32)
    kw = {} if packed is None else {"packed": packed}
    if engine == "fused128" and packed == "packed64":
        with pytest.raises(ValueError, match="packed64"):
            registry.build_for_serving(engine, x, device="cpu", **kw)
        return
    state = registry.build_for_serving(engine, x, device="cpu", **kw)
    spec = registry.packed_spec(state)
    if packed is None and engine != "packed_hybrid":
        assert spec is None
    else:
        want = packed if packed not in (None, "auto") else "packed64"
        assert spec.layout == want and spec == packing.spec_for(torch.from_numpy(x), x.size, want)
