"""repro_torch's baseline engines ``lca`` and ``exhaustive`` against the JAX reference.

The cases of ``tests/test_rmq_engines.py`` for the two engines: each runs
the same numpy input through the reference engine (``repro.core.registry``)
and the port's (on the CPU), and holds both to the numpy oracle: indices
equal and int32, values equal bit for bit and of x's dtype. ``LCARMQ`` is
compared with the reference's leaf for leaf, dtypes included. Tolerance:
exact.

Also pinned here: the maxval-only fault of the reference that the port
repairs (ROADMAP.md §3): on a range whose every element is the dtype's
maximum, the reference's blocked engines and ``exhaustive`` answer with an
index outside the range. The port answers the oracle there, and the tests
assert that the reference still does not (a deliberate divergence).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as jax_build
from repro.core import lca as jax_lca
from repro.core import ref
from repro.core import registry as jax_registry
from repro_torch.core import build, exhaustive, lca, registry
from torch_parity_util import assert_same_answer, assert_same_structure, to_np

BASELINES = ["lca", "exhaustive"]


def _queries(rng, n, b):
    l = rng.integers(0, n, b)
    r = rng.integers(0, n, b)
    return np.minimum(l, r), np.maximum(l, r)


def _both(engine, x, l, r):
    """(reference (idx, val), port (idx, val)) of ``engine`` on one input."""
    jeng = jax_registry.get(engine)
    want = jeng.query(jeng.build(jnp.asarray(x)), jnp.asarray(l), jnp.asarray(r))
    peng = registry.get(engine)
    got = peng.query(peng.build(x, device="cpu"), l, r)
    return want, got


@pytest.mark.parametrize("engine", BASELINES)
@pytest.mark.parametrize("n", [1, 2, 127, 128, 129, 1000, 4096])
def test_engine_matches_reference_and_oracle(engine, n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 17, n).astype(np.float32)  # dense ties
    l, r = _queries(rng, n, 200)
    want, got = _both(engine, x, l, r)
    assert_same_answer(want, got, x=x, gold=ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("engine", BASELINES)
def test_float_values(engine):
    rng = np.random.default_rng(777)
    x = rng.standard_normal(777).astype(np.float32)
    l, r = _queries(rng, 777, 300)
    want, got = _both(engine, x, l, r)
    assert_same_answer(want, got, x=x, gold=ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("engine", BASELINES)
def test_all_equal_prefers_leftmost(engine):
    rng = np.random.default_rng(500)
    x = np.zeros(500, np.float32)
    l, r = _queries(rng, 500, 100)
    want, got = _both(engine, x, l, r)
    assert_same_answer(want, got, x=x, gold=l)


@pytest.mark.parametrize("engine", BASELINES)
def test_paper_example(engine):
    """Section 2: X=[9,2,7,8,4,1,3], RMQ(2,6)=5."""
    x = np.array([9, 2, 7, 8, 4, 1, 3], np.float32)
    want, got = _both(engine, x, np.array([2]), np.array([6]))
    assert_same_answer(want, got, x=x, gold=np.array([5]))


@pytest.mark.parametrize("engine", BASELINES)
def test_values_returned_match_indices(engine):
    rng = np.random.default_rng(2048)
    x = rng.integers(0, 50, 2048).astype(np.float32)
    l, r = _queries(rng, 2048, 100)
    want, (idx, val) = _both(engine, x, l, r)
    np.testing.assert_array_equal(to_np(val), x[to_np(idx)])
    assert_same_answer(want, (idx, val), x=x, gold=ref.rmq_ref(x, l, r))


@pytest.mark.parametrize("n", [1, 2, 129, 1000])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_lca_structure_matches_reference(n, dtype):
    """euler_node, first and every level of the tour-depth table, dtypes
    included; the Cartesian tree's strict '>' keeps leftmost ties on top."""
    rng = np.random.default_rng(n + 1)
    x = rng.integers(0, 5, n).astype(dtype)
    assert_same_structure(jax_lca.build(jnp.asarray(x)), lca.build(x, device="cpu"))


def test_exhaustive_leftmost_ties_and_byte_bounded_chunks(monkeypatch):
    """``torch.argmin`` returns the first minimum, and the chunk bound by
    bytes changes nothing: one chunk, a byte bound of one query per chunk,
    and the registry's 64-query chunks give the same answers."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 3, 300).astype(np.float32)
    l, r = _queries(rng, 300, 150)
    gold = ref.rmq_ref(x, l, r)
    xt = torch.from_numpy(x)
    whole = exhaustive.rmq_exhaustive(xt, l, r, query_chunk=1024)
    monkeypatch.setattr(exhaustive, "_CHUNK_BYTES", 300 * 4)
    single = exhaustive.rmq_exhaustive(xt, l, r)
    assert whole.dtype == single.dtype == torch.int32
    np.testing.assert_array_equal(to_np(whole), gold)
    np.testing.assert_array_equal(to_np(single), gold)
    assert exhaustive.rmq_exhaustive(torch.zeros(64), [3], [60]).tolist() == [3]


def test_lca_serves_through_the_registry_plan():
    plan = registry.plan_for_serving("lca", 1000, "cpu")
    assert plan.engine == "lca" and plan.meta.get("threshold") is None
    assert "lca" in registry.serveable_names() and "exhaustive" not in registry.serveable_names()
    with pytest.raises(ValueError, match="not serveable"):
        registry.plan_for_serving("exhaustive", 1000, "cpu")


# --- the maxval-only fault (ROADMAP.md §3) ---------------------------------

MAXVAL_CASES = {
    "float32": np.array([0.0, np.inf, np.inf], np.float32),
    "int32": np.array([5, 2**31 - 1, 2**31 - 1], np.int32),
}
MAXVAL_L = np.array([1, 2, 1])
MAXVAL_R = np.array([2, 2, 1])
# Engines whose masked lanes carry maxval and win the tie in the reference:
# index 0. ``distributed`` and ``sharded_hybrid`` inherit it from the
# reference's ``block_rmq.query`` on their shards (``sharded_hybrid``'s
# sqrt(n) threshold sends these ranges to its blocked path);
# ``packed_sharded_hybrid``'s packed words were never at fault.
MAXVAL_FAULTY = [
    "block128",
    "block256",
    "lane",
    "exhaustive",
    "fused128",
    "fused128_dma",
    "hybrid",
    "distributed",
    "sharded_hybrid",
]


@pytest.mark.parametrize("dtype", sorted(MAXVAL_CASES))
@pytest.mark.parametrize("engine", registry.names())
def test_maxval_only_range_matches_reference(engine, dtype):
    """The port answers the oracle on the maxval-only ranges. The reference
    does too, except on the engines of ``MAXVAL_FAULTY``, where it still
    answers index 0, outside every range: the port's repair is a deliberate
    divergence, and this fails if the reference changes."""
    x = MAXVAL_CASES[dtype]
    gold = ref.rmq_ref(x, MAXVAL_L, MAXVAL_R).astype(np.int32)
    want, got = _both(engine, x, MAXVAL_L, MAXVAL_R)
    if engine in MAXVAL_FAULTY:
        np.testing.assert_array_equal(to_np(want[0]), [0, 0, 0])
        want = (gold, x[gold])
    assert_same_answer(want, got, x=x, gold=gold)


@pytest.mark.parametrize("dtype", sorted(MAXVAL_CASES))
@pytest.mark.parametrize("engine", MAXVAL_FAULTY)
def test_maxval_only_range_matches_oracle(engine, dtype):
    x = MAXVAL_CASES[dtype]
    peng = registry.get(engine)
    idx, _ = peng.query(peng.build(x, device="cpu"), MAXVAL_L, MAXVAL_R)
    np.testing.assert_array_equal(to_np(idx), ref.rmq_ref(x, MAXVAL_L, MAXVAL_R))


@pytest.mark.parametrize("threshold", [1, 3])
def test_maxval_only_range_quantized_packed_hybrid(threshold):
    """Quantized ``packed_hybrid`` on the int32 input (finite, so the layout
    accepts it): its raw-value partials go through the repaired masked min.
    The port answers the oracle. The reference's short path (ranges of at
    most ``threshold`` elements) still answers index 0; its long path, the
    packed table, is right."""
    x = MAXVAL_CASES["int32"]
    gold = ref.rmq_ref(x, MAXVAL_L, MAXVAL_R).astype(np.int32)
    jeng = jax_registry.get("packed_hybrid")
    jstate = jax_build.build(
        "hybrid", jnp.asarray(x), block_size=128, packed="quantized", threshold=threshold
    )
    want = jeng.query(jstate, jnp.asarray(MAXVAL_L), jnp.asarray(MAXVAL_R))
    short = MAXVAL_R - MAXVAL_L + 1 <= threshold
    np.testing.assert_array_equal(to_np(want[0]), np.where(short, 0, gold))
    state = build.build(
        "hybrid", x, device="cpu", block_size=128, packed="quantized", threshold=threshold
    )
    assert state.spec.layout == "quantized"
    got = registry.get("packed_hybrid").query(state, MAXVAL_L, MAXVAL_R)
    assert_same_answer((gold, x[gold]), got, x=x, gold=gold)
