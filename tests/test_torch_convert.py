"""Structures built by the JAX reference, queried by repro_torch.

``repro_torch.convert`` takes the reference's structures with numpy leaves
and returns the port's on a device. Built in JAX and queried by the port,
they must answer exactly as JAX does: indices equal and int32, values equal
and of x's dtype. Tolerance: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import block_rmq as jax_block_rmq
from repro.core import hybrid as jax_hybrid
from repro.core import ref
from repro.core import sparse_table as jax_sparse_table
from repro.kernels import ops as jax_ops
from repro_torch import convert
from repro_torch.core import block_rmq, hybrid, sparse_table
from repro_torch.core.block_rmq import BlockRMQ
from repro_torch.kernels import ops
from torch_parity_util import assert_same_answer, assert_same_structure


def _host(s):
    return jax.tree_util.tree_map(np.asarray, s)


def _case(seed, n, dtype):
    rng = np.random.default_rng(seed)
    x = rng.random(n, dtype=np.float32) if dtype == "f32" else rng.integers(-4, 4, n).astype(np.int32)
    a = rng.integers(0, n, 64)
    b = rng.integers(0, n, 64)
    return x, np.minimum(a, b), np.maximum(a, b)


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_sparse_table_and_block_rmq_round_trip(dtype):
    x, l, r = _case(1, 1500, dtype)
    gold = ref.rmq_ref(x, l, r)
    jt = jax_sparse_table.build(jnp.asarray(x))
    pt = convert.sparse_table(_host(jt), device="cpu")
    assert_same_structure(jt, pt)
    np.testing.assert_array_equal(sparse_table.query(pt, l, r).numpy(), np.asarray(jax_sparse_table.query(jt, jnp.asarray(l), jnp.asarray(r))))

    js = jax_block_rmq.build(jnp.asarray(x), 128)
    ps = convert.block_rmq(_host(js), device="cpu")
    assert_same_structure(js, ps)
    assert_same_answer(jax_block_rmq.query(js, jnp.asarray(l), jnp.asarray(r)), block_rmq.query(ps, l, r), x=x, gold=gold)


@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_fused_rmq_round_trip_both_fetches(dtype):
    x, l, r = _case(2, 12 * 128 + 7, dtype)
    js = jax_ops.build(jnp.asarray(x), 128, interpret=True)
    ps = convert.fused_rmq(_host(js), device="cpu")
    assert isinstance(ps, ops.FusedRMQ)
    assert_same_structure(js, ps)
    for fetch in ("resident", "dma"):
        want = jax_ops.query(js, jnp.asarray(l), jnp.asarray(r), fetch=fetch, interpret=True)
        assert_same_answer(want, ops.query(ps, l, r, fetch=fetch), x=x, gold=ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hybrid_round_trip_mixed_batch(use_kernels):
    x, l, r = _case(3, 4000, "f32")
    jh = jax_hybrid.build(jnp.asarray(x), 128, threshold=200, use_kernels=False)
    ph = convert.hybrid(_host(jh._replace(short_fn=None, long_fn=None)), device="cpu", use_kernels=use_kernels)
    assert ph.threshold == 200 and ph.use_kernels == use_kernels
    assert isinstance(ph.blocked, ops.FusedRMQ) == use_kernels
    assert_same_structure((jh.blocked, jh.st, jh.x), (BlockRMQ(*ph.blocked[:4]), ph.st, ph.x))
    short = (r - l + 1) <= 200
    assert 0 < short.sum() < short.size
    assert_same_answer(jax_hybrid.query(jh, l, r), hybrid.query(ph, l, r), x=x, gold=ref.rmq_ref(x, l, r))


def test_convert_rejects_non_int32_index_leaves():
    jt = _host(jax_sparse_table.build(jnp.arange(8.0, dtype=jnp.float32)))
    with pytest.raises(TypeError, match="int32"):
        convert.sparse_table(jt._replace(idx=jt.idx.astype(np.int64)), device="cpu")
