"""repro_torch registry engines and hybrid dispatch against the JAX reference.

Every port engine runs the conformance scenarios of
``tests/test_conformance.py`` on the CPU beside the same reference engine
(``repro.core.registry``): indices equal and int32, values equal and of x's
dtype, both equal to the numpy oracle, and the built structures equal leaf
for leaf (``tests/test_torch_paths_conformance.py`` runs the packed layouts
and the two-pass query through the same scenarios). The hybrid's dispatch
traps are pinned here too. Tolerance: exact.
"""

import importlib.util
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jax_hybrid
from repro.core import ref
from repro.core import registry as jax_registry
from repro_torch.core import build as build_mod
from repro_torch.core import hybrid, registry
from torch_parity_util import assert_same_answer, assert_same_structure, to_np

_spec = importlib.util.spec_from_file_location(
    "_reference_conformance", Path(__file__).with_name("test_conformance.py")
)
_conformance = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_conformance)
SCENARIOS = _conformance.SCENARIOS

ENGINES = [
    "sparse_table",
    "block128",
    "block256",
    "lane",
    "lca",
    "exhaustive",
    "fused128",
    "fused128_dma",
    "hybrid",
    "packed_hybrid",
    # The mesh engines, on a one-shard CPU mesh beside the reference's
    # one-device mesh (``build(x, device="cpu")``: ``default_mesh("cpu")``).
    "distributed",
    "sharded_hybrid",
    "packed_sharded_hybrid",
]


def test_port_registry_has_the_served_engines():
    assert registry.names() == tuple(ENGINES)
    assert registry.serveable_names() == tuple(e for e in ENGINES if e != "exhaustive")
    assert set(ENGINES) <= set(jax_registry.names())


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_conformance_matches_reference(engine, scenario):
    rng = np.random.default_rng(zlib.crc32(scenario.encode()))
    x, l, r = SCENARIOS[scenario](rng)
    gold = ref.rmq_ref(x, l, r)

    jeng = jax_registry.get(engine)
    js = jeng.build(jnp.asarray(x))
    want = jeng.query(js, jnp.asarray(l), jnp.asarray(r))

    peng = registry.get(engine)
    ps = peng.build(x, device="cpu")
    got = peng.query(ps, l, r)
    assert_same_answer(want, got, x=x, gold=gold)
    assert_same_structure(js, ps)


def test_hybrid_mixed_batch_matches_reference():
    """One batch with short and long ranges: split, two launches, scatter."""
    rng = np.random.default_rng(6)
    n = 3000
    x = rng.integers(0, 7, n).astype(np.float32)
    a = rng.integers(0, n, 200)
    b = rng.integers(0, n, 200)
    l, r = np.minimum(a, b), np.maximum(a, b)
    js = jax_hybrid.build(jnp.asarray(x), 128, threshold=300, use_kernels=False)
    for use_kernels in (False, True):  # True: the kernel path's plain version
        ps = hybrid.build(x, 128, threshold=300, use_kernels=use_kernels, device="cpu")
        short = (r - l + 1) <= 300
        assert 0 < short.sum() < short.size
        splits = []
        with hybrid.record_splits(lambda s, g: splits.append((s, g))):
            got = hybrid.query(ps, l, r)
        assert splits == [(int(short.sum()), int((~short).sum()))]
        assert_same_answer(jax_hybrid.query(js, l, r), got, x=x, gold=ref.rmq_ref(x, l, r))


def test_hybrid_kernel_path_structure_matches_reference():
    """use_kernels=True builds the FusedRMQ through ``block_min`` (plain
    version on the CPU), equal leaf for leaf to the reference's kernel build."""
    rng = np.random.default_rng(7)
    x = rng.random(20 * 128 + 3, dtype=np.float32)
    from repro.kernels import ops as jax_ops

    ps = hybrid.build(x, 128, use_kernels=True, device="cpu")
    assert_same_structure(jax_ops.build(jnp.asarray(x), 128, interpret=True), ps.blocked)
    assert ps.use_kernels and ps.threshold == round(len(x) ** 0.5)


def test_dispatch_pads_each_launch_to_a_power_of_two():
    seen = []

    def fn(tag):
        def run(l, r):
            seen.append((tag, to_np(l).tolist(), to_np(r).tolist(), l.dtype))
            return l.clone(), l.to(torch.float32)

        return run

    l = np.array([0, 3, 10, 20, 1], np.int64)
    r = np.array([1, 3, 90, 95, 2], np.int64)
    idx, val = hybrid.dispatch_by_length(l, r, 4, fn("short"), fn("long"), torch.float32, torch.device("cpu"))
    assert seen == [
        ("short", [0, 3, 1, 0], [1, 3, 2, 0], torch.int32),  # 3 short -> 4, one (0, 0) pad
        ("long", [10, 20], [90, 95], torch.int32),
    ]
    assert idx.dtype == torch.int32 and idx.tolist() == [0, 3, 10, 20, 1]  # scattered back in order
    assert val.dtype == torch.float32


def test_dispatch_rejects_non_integer_and_out_of_range_bounds():
    cpu = torch.device("cpu")
    with pytest.raises(TypeError):
        hybrid.dispatch_by_length(np.array([0.0]), np.array([1.0]), 4, None, None, torch.float32, cpu)
    with pytest.raises(ValueError, match="int32"):
        hybrid.dispatch_by_length(np.array([0]), np.array([2**31]), 4, None, None, torch.float32, cpu)
    with pytest.raises(ValueError, match="int32"):
        hybrid.dispatch_by_length(np.array([-1]), np.array([2]), 4, None, None, torch.float32, cpu)
    boom = lambda *a: (_ for _ in ()).throw(AssertionError("launched on an empty batch"))
    idx, val = hybrid.dispatch_by_length(np.zeros(0, np.int64), np.zeros(0, np.int64), 4, boom, boom, torch.int32, cpu)
    assert idx.shape == (0,) and idx.dtype == torch.int32 and val.dtype == torch.int32


def test_build_policies_not_ported_yet_raise(tmp_path, monkeypatch):
    """The cache policies that earlier slices left unported now resolve:
    "cached" falls back to sqrt(n) and the default geometry on an empty
    cache, "calibrated" and "tuned" measure on a miss (here a fake
    measurement), and nothing raises ``NotImplementedError``."""
    monkeypatch.setenv("RMQ_TORCH_CALIB_CACHE", str(tmp_path / "cal.json"))
    monkeypatch.setattr(hybrid, "_measure", lambda kind, *a: 0.0 if kind == "short" else 1.0)
    cached = build_mod.plan_for(
        "hybrid", 1024, device="cpu", use_kernels=True, threshold="cached", kernel_config="cached"
    )
    assert cached.meta["threshold"] == 32 and cached.meta["kernel_config"].tile == 8
    tuned = build_mod.plan_for(
        "hybrid", 1024, device="cpu", use_kernels=True, threshold="calibrated", kernel_config="tuned"
    )
    assert tuned.meta["threshold"] == 1024  # the short path won at every length
    assert tuned.meta["kernel_config"].block_size == 128
    with pytest.raises(ValueError):
        build_mod.plan_for("hybrid", 1024, device="cpu", threshold="measured")
    with pytest.raises(ValueError):
        registry.plan_for_serving("fused128", 1024, "cpu", threshold=5)
    plan = registry.plan_for_serving("hybrid", 1024, "cpu", threshold=32)
    assert plan.meta["threshold"] == 32 and not plan.meta["use_kernels"]
    assert build_mod.warmup_bounds(plan)(2)[0][1].tolist() == [31, 31]
