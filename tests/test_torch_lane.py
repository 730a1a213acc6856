"""repro_torch lane RMQ and its ``lane_partials`` kernel against the reference.

The same numpy input goes through ``repro.core.lane_rmq`` /
``repro.kernels.ops.lane_query`` (the Pallas kernel in interpret mode, as
``tests/test_lane_kernel.py`` runs it) and through the port
(``core.lane_rmq`` and ``kernels.ops.lane_query``, whose kernel wrapper runs
its plain version for CPU tensors). Tolerance: exact — indices int32 and
equal, values of x's dtype and equal bit for bit (-0.0 included), the built
structure equal leaf for leaf.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lane_rmq as jax_lane_rmq
from repro.core import ref
from repro.kernels import ops as jax_ops
from repro.kernels.lane_query import lane_partials as jax_lane_partials
from repro_torch.core import lane_rmq
from repro_torch.kernels import ops
from repro_torch.kernels.lane_query import lane_partials, lane_partials_plain
from torch_parity_util import assert_same_structure, to_np


def _bits_equal(want, got):
    """Output pairs equal with dtypes pinned, values bit for bit."""
    for a, b in zip(want, got):
        a, b = np.asarray(a), to_np(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(b.view(np.int32), a.view(np.int32))


def _data(rng, n, dtype):
    x = rng.integers(0, 25, n).astype(dtype)  # dense ties, as the reference test
    if dtype == np.float32:
        x[rng.integers(0, n, n // 5)] = -0.0
        x[rng.integers(0, n, n // 5)] = 0.0
    return x


def _ranges(rng, n, b):
    l = rng.integers(0, n, b)
    r = rng.integers(0, n, b)
    l, r = np.minimum(l, r), np.maximum(l, r)
    l[:3] = [0, n // 2, n - 1]  # full range and l == r queries
    r[:3] = [n - 1, n // 2, n - 1]
    return l, r


@pytest.mark.parametrize("n", [130, 1000])  # one and many interior lane blocks
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_lane_rmq_matches_reference(n, dtype):
    """Build leaf for leaf; ``lane_rmq.query`` and ``ops.lane_query`` equal
    the reference's on the same bits, and the oracle."""
    rng = np.random.default_rng(n)
    x = _data(rng, n, dtype)
    js = jax_lane_rmq.build(jnp.asarray(x))
    ps = lane_rmq.build(x, device="cpu")
    assert_same_structure(js, ps)
    np.testing.assert_array_equal(to_np(ps.pref_val).view(np.int32), np.asarray(js.pref_val).view(np.int32))
    np.testing.assert_array_equal(to_np(ps.suff_val).view(np.int32), np.asarray(js.suff_val).view(np.int32))
    l, r = _ranges(rng, n, 64)
    gold = ref.rmq_ref(x, l, r)
    want = jax_lane_rmq.query(js, jnp.asarray(l), jnp.asarray(r))
    got = lane_rmq.query(ps, l, r)
    assert got[0].dtype == torch.int32 and got[1].dtype == ps.xs.dtype
    _bits_equal(want, got)
    np.testing.assert_array_equal(to_np(got[0]), gold)
    kwant = jax_ops.lane_query(js, jnp.asarray(l), jnp.asarray(r), interpret=True)
    kgot = ops.lane_query(ps, l, r)
    assert kgot[0].dtype == torch.int32
    _bits_equal(kwant, kgot)
    np.testing.assert_array_equal(to_np(kgot[0]), gold)
    np.testing.assert_array_equal(to_np(kgot[1]), x[gold])


@pytest.mark.parametrize("tile", [4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_lane_partials_matches_pallas(dtype, tile):
    """The kernel wrapper's plain version against the Pallas kernel (its
    same-block rows and straddle picks), B = 37: not a multiple of the tile."""
    rng = np.random.default_rng(7)
    n = 1000  # a shape the test above compiles the reference for already
    x = _data(rng, n, dtype)
    js = jax_lane_rmq.build(jnp.asarray(x))
    ps = lane_rmq.build(x, device="cpu")
    l, r = _ranges(rng, n, 37)
    l[3:9] = r[3:9] - rng.integers(0, 100, 6).clip(max=r[3:9])  # short, often same-block
    sl, sr = l // 128, r // 128
    llo, rlo = l - sl * 128, r - sr * 128
    jargs = [jnp.asarray(a.astype(np.int32)) for a in (sl, sr, llo, rlo)]
    want = jax_lane_partials(
        js.xs, js.suff_val, js.suff_idx, js.pref_val, js.pref_idx, *jargs, tile=tile, interpret=True
    )
    planes = (ps.xs, ps.suff_val, ps.suff_idx, ps.pref_val, ps.pref_idx)
    got = lane_partials(*planes, sl, sr, llo, rlo, tile=tile)
    assert got[1].dtype == torch.int32
    _bits_equal(want, got)
    targs = [torch.from_numpy(a.astype(np.int32)) for a in (sl, sr, llo, rlo)]
    _bits_equal(got, lane_partials_plain(*planes, *targs))


@pytest.mark.parametrize("last", ["same", "straddle"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_lane_partials_same_block_warp_matches_pallas(dtype, last):
    """B = 33: the first 32 queries each inside one lane block, the 33rd
    inside one block or straddling. On these CPU tensors the wrapper runs
    its plain version, so this holds the plain version to the Pallas kernel;
    tests/test_torch_cuda.py runs the same shape through the CUDA kernel (its
    ballot over same-block queries, a warp with one live lane)."""
    rng = np.random.default_rng(33)
    n = 1000
    x = _data(rng, n, dtype)
    js = jax_lane_rmq.build(jnp.asarray(x))
    ps = lane_rmq.build(x, device="cpu")
    blk = rng.integers(0, n // 128, 33)
    a, c = rng.integers(0, 128, 33), rng.integers(0, 128, 33)
    l, r = blk * 128 + np.minimum(a, c), blk * 128 + np.maximum(a, c)
    l[0], r[0] = 128, 255  # a whole block
    if last == "straddle":
        l[32], r[32] = 5, n - 1
    sl, sr = l // 128, r // 128
    assert (sl[:32] == sr[:32]).all() and (sl[32] == sr[32]) == (last == "same")
    args = [a.astype(np.int32) for a in (sl, sr, l - sl * 128, r - sr * 128)]
    want = jax_lane_partials(
        js.xs, js.suff_val, js.suff_idx, js.pref_val, js.pref_idx, *map(jnp.asarray, args),
        tile=8, interpret=True,
    )
    planes = (ps.xs, ps.suff_val, ps.suff_idx, ps.pref_val, ps.pref_idx)
    got = lane_partials(*planes, *args)
    _bits_equal(want, got)
    np.testing.assert_array_equal(to_np(got[0])[:32], x[ref.rmq_ref(x, l, r)][:32])
    _bits_equal(got, lane_partials_plain(*planes, *map(torch.from_numpy, args)))


def test_lane_partials_checks_its_inputs():
    ps = lane_rmq.build(np.arange(300, dtype=np.float32), device="cpu")
    planes = (ps.xs, ps.suff_val, ps.suff_idx, ps.pref_val, ps.pref_idx)
    with pytest.raises(TypeError):
        lane_partials(ps.xs.double(), *planes[1:], [0], [1], [0], [5])
    with pytest.raises(ValueError):
        lane_partials(*planes, [0, 1], [1], [0], [5])
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no quiet fallback
        meta = tuple(t.to("meta") for t in planes)
        lane_partials(*meta, [0], [1], [0], [5])
    val, idx = lane_partials(*planes, [0], [1], [3], [5])
    assert idx.dtype == torch.int32 and idx.tolist() == [3] and val.tolist() == [3.0]
