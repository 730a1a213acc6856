"""repro_torch's sharded hybrid, its planners, calibration and serving on CPU meshes.

Ports of the reference's mesh cases that run on one device: the three
modes on a one-shard mesh beside the reference's one-device mesh
(``tests/test_conformance.py``), the packed tier on an 8-shard mesh with
its online patch (``tests/test_packing.py``) and its quantized refusal, the mesh calibration cases of
``tests/test_calibration.py`` through the ``_measure`` / ``calibrate``
seams, the registry's capability metadata of ``tests/test_serve.py``, the
stage sequences of ``tests/test_build_plan.py``, the serve CLI with
``--qshard``, ``--qshard 2d`` and ``--engine distributed``, and an
``RMQServer`` with two workers over an 8-shard CPU mesh, every answer held
to the oracle. Also ``launch.mesh``. Tolerance: exact.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import update as jax_update
from repro.core import calib_cache as jax_cache
from repro.core import ref
from repro.core import registry as jax_registry
from repro.core import sharded_hybrid as jax_sharded_hybrid
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch import update
from repro_torch.core import block_rmq, calib_cache, hybrid, registry, sharded_hybrid
from repro_torch.core import build as build_mod
from repro_torch.launch import serve
from repro_torch.launch.mesh import factor_2d, make_group_mesh, make_mesh, make_production_mesh, set_mesh
from repro_torch.serve import RMQServer, ServeConfig
from repro_torch.serve.workload import make_queries, run_poisson_clients
from torch_parity_util import assert_same_answer, assert_same_structure, to_np


def _bounded(rng, n, b):
    l = rng.integers(0, n, b)
    r = rng.integers(0, n, b)
    return np.minimum(l, r), np.maximum(l, r)


def _cpu_mesh(shape=(8,), axes=("shard",)):
    return make_mesh(shape, axes, devices="cpu")


# --- launch.mesh ------------------------------------------------------------


def test_mesh_positions_and_physical_devices():
    mesh = make_mesh((2, 4), ("data", "model"), devices="cpu")
    assert mesh.shape == {"data": 2, "model": 4} and mesh.devices.shape == (2, 4) and mesh.size == 8
    assert mesh.physical_devices == (torch.device("cpu"),)  # eight shards, one device
    assert make_group_mesh(["cpu", "cpu"]).axis_names == ("shard",)
    assert factor_2d(8) == (2, 4) and factor_2d(1) == (1, 1) and factor_2d(7) == (1, 7)
    prod = make_production_mesh(multi_pod=True)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16} and prod.physical_devices == (torch.device("meta"),)
    with set_mesh(mesh) as m:
        assert m is mesh
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2, 4), ("data",), devices="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh((8,), ("shard",))  # the card by default: no CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            registry.build_for_serving("sharded_hybrid", np.zeros(64, np.float32))


# --- the three modes ---------------------------------------------------------


@pytest.mark.parametrize("mode", sharded_hybrid.MODES)
def test_sharded_hybrid_modes_match_single_device(mode):
    """Every mode agrees with the reference (its one-device mesh) and the
    oracle on a one-shard mesh, leaf for leaf."""
    rng = np.random.default_rng(5)
    n = 1500
    x = rng.integers(0, 6, n).astype(np.float32)
    l, r = _bounded(rng, n, 100)
    js = jax_sharded_hybrid.build(jnp.asarray(x), jax_make_mesh((1,), ("shard",)), ("shard",), 128, mode=mode)
    ps = sharded_hybrid.build(x, _cpu_mesh((1,)), ("shard",), 128, mode=mode)
    assert ps.threshold == js.threshold and ps.n_shards == js.n_shards == 1
    assert_same_answer(jax_sharded_hybrid.query(js, l, r), sharded_hybrid.query(ps, l, r), x=x, gold=ref.rmq_ref(x, l, r))
    assert_same_structure((js.blocked, js.st), (ps.blocked, ps.st))


def test_sharded_hybrid_empty_batch():
    s = sharded_hybrid.build(np.arange(256.0, dtype=np.float32), device="cpu")
    boom = lambda *a: (_ for _ in ()).throw(AssertionError("launched on empty batch"))
    s = s._replace(short_fn=boom, long_fn=boom)
    idx, val = sharded_hybrid.query(s, np.zeros(0, np.int64), np.zeros(0, np.int64))
    assert idx.shape == (0,) and val.shape == (0,)
    assert idx.dtype == torch.int32 and val.dtype == torch.float32


def test_sharded_hybrid_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        sharded_hybrid.build(np.arange(256.0, dtype=np.float32), mode="shard_everything", device="cpu")


@pytest.mark.parametrize("mode", sharded_hybrid.MODES)
@pytest.mark.parametrize("layout", ["packed32", "packed64"])
def test_packed_mesh_conformance_8_shards(layout, mode):
    """packed32 and packed64 sharded hybrids, every mode, on an 8-shard
    mesh: equal to the single-host blocked query bit for bit."""
    rng = np.random.default_rng(0)
    n = 1 << 11
    x = (rng.integers(-1000, 1000, n).astype(np.int32) if layout == "packed32"
         else rng.standard_normal(n).astype(np.float32))
    oi, ov = block_rmq.query(block_rmq.build(x, 128, device="cpu"), *_bounded(np.random.default_rng(1), n, 256))
    s = sharded_hybrid.build(x, _cpu_mesh(), ("shard",), 128, threshold=64, mode=mode, packed=layout)
    assert s.spec.layout == layout
    qi, qv = sharded_hybrid.query(s, *_bounded(np.random.default_rng(1), n, 256))
    np.testing.assert_array_equal(to_np(qi), to_np(oi))
    np.testing.assert_array_equal(to_np(qv).view(np.int32), to_np(ov).view(np.int32))


def test_quantized_rejected_on_mesh():
    x = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    for engine in ("sharded_hybrid", "distributed"):
        with pytest.raises(ValueError, match="single-host"):
            build_mod.build(engine, x, mesh=_cpu_mesh((1,)), axis_names=("shard",), packed="quantized")


def test_mesh_passed_to_a_single_device_engine_raises():
    with pytest.raises(ValueError, match="one device"):
        build_mod.plan_for("hybrid", 64, device="cpu", mesh=_cpu_mesh())


# --- calibration on a mesh (tests/test_calibration.py) -----------------------


def test_calibrate_with_mesh_uses_sharded_constituents(monkeypatch):
    """The mesh path times the sharded blocked / sharded table paths, not
    the single-host HybridRMQ closures."""
    built = {}
    real_build = sharded_hybrid.build

    def spy_build(x, mesh=None, axis_names=None, *a, **kw):
        built["mesh"] = mesh
        built["mode"] = kw.get("mode")
        return real_build(x, mesh, axis_names, *a, **kw)

    monkeypatch.setattr(sharded_hybrid, "build", spy_build)
    monkeypatch.setattr(hybrid, "_measure", lambda kind, *a, **k: 1.0 if kind == "short" else 0.0)
    mesh = _cpu_mesh((1,))
    thr = hybrid.calibrate(256, batch=8, repeats=1, mesh=mesh, axis_names=("shard",), mode="shard_batch")
    assert thr == 0  # long wins everywhere -> route everything long
    assert built["mesh"] is mesh and built["mode"] == "shard_batch"


def test_sharded_build_calibrated_passes_mesh_to_calibrate(tmp_path, monkeypatch):
    """threshold="calibrated" on a sharded build requests a sharded
    measurement (mesh and mode forwarded) and persists it under the v2 key,
    the reference's key string."""
    p = tmp_path / "cal.json"
    seen = {}

    def fake_calibrate(n, **kw):
        seen.update(kw, n=n)
        return 17

    monkeypatch.setattr(hybrid, "calibrate", fake_calibrate)
    s = sharded_hybrid.build(np.zeros(512, np.float32), threshold="calibrated", cache_path=p, device="cpu")
    assert s.threshold == 17
    assert seen["mesh"] is not None and seen["mode"] == "shard_structure"
    assert seen["axis_names"] == ("shard",)
    key = calib_cache.cache_key(512, 128, backend="cpu", n_devices=1, mode="shard_structure", mesh_shape=(1,))
    assert key == jax_cache.cache_key(512, 128, backend="cpu", n_devices=1, mode="shard_structure", mesh_shape=(1,))
    assert calib_cache.load(key, path=p) == 17
    # The v1 key does not own the sharded measurement.
    assert calib_cache.load(calib_cache.cache_key(512, 128, backend="cpu", n_devices=1), path=p) is None
    monkeypatch.setattr(hybrid, "calibrate", lambda *a, **k: pytest.fail("re-measured on a hit"))
    s2 = sharded_hybrid.build(np.zeros(512, np.float32), threshold="calibrated", cache_path=p, device="cpu")
    assert s2.threshold == 17


def test_modes_no_longer_share_one_threshold_slot(tmp_path, monkeypatch):
    """Each mode (and mesh factoring) resolves its own cache entry."""
    p = tmp_path / "cal.json"
    key = calib_cache.cache_key(640, 128, backend="cpu", n_devices=1, mode="shard_structure", mesh_shape=(1,))
    calib_cache.store(key, 99, path=p)
    monkeypatch.setattr(hybrid, "calibrate", lambda *a, **k: pytest.fail('"cached" must never measure'))
    hit = sharded_hybrid.build(np.zeros(640, np.float32), threshold="cached", cache_path=p, device="cpu")
    assert hit.threshold == 99
    other = sharded_hybrid.build(
        np.zeros(640, np.float32), threshold="cached", cache_path=p, mode="shard_batch", device="cpu"
    )
    assert other.threshold == 25  # round(sqrt(640)) fallback, not 99


def test_get_threshold_v2_forwards_mode_to_calibrate(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    seen = {}
    monkeypatch.setattr(hybrid, "calibrate", lambda n, **kw: seen.update(kw) or 13)
    thr = calib_cache.get_threshold(
        256, 128, backend="cpu", n_devices=4, mode="shard_2d", mesh_shape=(2, 2), path=p
    )
    assert thr == 13 and seen["mode"] == "shard_2d"
    key = calib_cache.cache_key(256, 128, backend="cpu", n_devices=4, mode="shard_2d", mesh_shape=(2, 2))
    assert calib_cache.load(key, path=p) == 13


def test_sharded_hybrid_build_reads_cache_without_measuring(tmp_path, monkeypatch):
    """The 8-shard (2, 4) key carries ndev=8 and the mesh shape; "cached"
    without an entry falls back to sqrt(n), never measuring."""
    p = tmp_path / "cal.json"
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    key = calib_cache.cache_key(777, 128, backend="cpu", n_devices=8, mode="shard_structure", mesh_shape=(2, 4))
    calib_cache.store(key, 55, path=p)
    monkeypatch.setattr(hybrid, "calibrate", lambda *a, **k: pytest.fail('"cached"/None must never measure'))
    s = sharded_hybrid.build(np.zeros(777, np.float32), mesh, threshold="cached", cache_path=p)
    assert s.threshold == 55 and s.n_shards == 8
    s2 = sharded_hybrid.build(np.zeros(778, np.float32), mesh, threshold="cached", cache_path=p)
    assert s2.threshold == round(778**0.5)


def test_plan_metadata_threshold_resolution(tmp_path):
    """Sharded plans read the v2 key (mode + mesh shape); a v1 entry for the
    same configuration is not consulted."""
    p = tmp_path / "cal.json"
    calib_cache.store(calib_cache.cache_key(1000, 128, backend="cpu", n_devices=1), 99, path=p)
    calib_cache.store(
        calib_cache.cache_key(1000, 128, backend="cpu", n_devices=1, mode="shard_structure", mesh_shape=(1,)),
        55,
        path=p,
    )
    plan = build_mod.plan_for("sharded_hybrid", 1000, device="cpu", threshold="cached", cache_path=p)
    assert plan.meta["threshold"] == 55
    [(ls, rs), (ll, rl)] = build_mod.warmup_bounds(plan)(4)
    assert rs[0] - ls[0] + 1 == 55 and rl[0] - ll[0] + 1 == 1000


# --- the BuildPlan stages (tests/test_build_plan.py) -------------------------


@pytest.mark.parametrize(
    "engine,kwargs,has_halo",
    [
        ("sparse_table", {}, False),
        ("block", {"block_size": 128}, False),
        ("hybrid", {"block_size": 128}, False),
        ("sharded_st", {}, True),
        ("sharded_hybrid", {"block_size": 128}, True),
        ("sharded_hybrid", {"block_size": 128, "mode": "shard_batch"}, False),
        ("sharded_hybrid", {"block_size": 128, "packed": "packed64"}, True),
        ("distributed", {"block_size": 128}, False),
    ],
)
def test_stage_sequence(engine, kwargs, has_halo):
    """The observer sees the declared stages in canonical order; the halo
    stage appears exactly when the plan builds a structure-sharded doubling
    table."""
    plan = build_mod.plan_for(engine, 300, device="cpu", **kwargs)
    seen = []
    build_mod.execute(plan, np.arange(300.0, dtype=np.float32), observer=lambda name, state: seen.append(name))
    assert seen == [s.name for s in plan.stages]
    assert seen[0] == "shard_layout" and seen[-1] == "finalize"
    assert ("halo_exchange" in seen) == has_halo
    order = [build_mod.STAGE_NAMES.index(s) for s in seen]
    assert order == sorted(order)


# --- the registry's mesh engines (tests/test_serve.py) -----------------------


def test_serveable_names_excludes_oracles():
    names = registry.serveable_names()
    assert "exhaustive" not in names
    for flagship in ("hybrid", "sharded_hybrid", "fused128", "distributed", "packed_sharded_hybrid"):
        assert flagship in names
    assert set(names) <= set(jax_registry.serveable_names())


def test_capability_metadata_drives_flags():
    for name in ("sharded_hybrid", "packed_sharded_hybrid"):
        sh = registry.get(name)
        assert sh.modes == jax_registry.get(name).modes == sharded_hybrid.MODES and sh.needs_mesh
        assert sh.build_kwargs == jax_registry.get(name).build_kwargs
    hy = registry.get("hybrid")
    assert "threshold" in hy.build_kwargs and not hy.needs_mesh and hy.modes == ()
    dist = registry.get("distributed")
    assert dist.needs_mesh and dist.build_kwargs == jax_registry.get("distributed").build_kwargs
    assert registry.plan_for_serving("distributed", 4096, "cpu").meta["block_size"] == 1024
    for name in ("distributed", "sharded_hybrid", "packed_sharded_hybrid"):
        assert registry.get(name).updatable and jax_registry.get(name).updatable


def test_build_for_serving_validates_kwargs():
    x = np.arange(256.0, dtype=np.float32)
    with pytest.raises(ValueError):
        registry.build_for_serving("lca", x, device="cpu", threshold=7)  # undeclared kwarg
    with pytest.raises(ValueError, match="mode"):
        registry.build_for_serving("sharded_hybrid", x, device="cpu", mode="shard_everything")
    with pytest.raises(ValueError, match="does not accept"):
        registry.build_for_serving("hybrid", x, device="cpu", mesh=_cpu_mesh())  # not a mesh engine
    with pytest.raises(ValueError):
        registry.build_for_serving("exhaustive", x, device="cpu")  # not serveable
    state = registry.build_for_serving("hybrid", x, device="cpu", threshold=32)
    assert state.threshold == 32
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    state = registry.build_for_serving("sharded_hybrid", x, mesh=mesh, mode="shard_2d", threshold=32)
    assert state.mode == "shard_2d" and state.n_shards == 8
    assert state.blocked.x_blocks.num_shards == 2  # the structure over "data" only


def test_distributed_registry_engine_matches_oracle():
    rng = np.random.default_rng(6)
    n = 777
    x = rng.integers(0, 5, n).astype(np.float32)
    l, r = _bounded(rng, n, 50)
    gold = ref.rmq_ref(x, l, r)
    jspec = jax_registry.get("distributed")
    want = jspec.query(jspec.build(jnp.asarray(x)), jnp.asarray(l), jnp.asarray(r))
    spec = registry.get("distributed")
    assert_same_answer(want, spec.query(spec.build(x, device="cpu"), l, r), x=x, gold=gold)
    got = spec.query(spec.build(x, mesh=_cpu_mesh((2, 4), ("data", "model"))), l, r)
    assert_same_answer(want, got, x=x, gold=gold)


# --- the serve CLI -----------------------------------------------------------


@pytest.mark.parametrize(
    "argv,tag",
    [
        (["--engine", "sharded_hybrid"], "[sharded_hybrid]"),
        (["--engine", "sharded_hybrid", "--qshard"], "[sharded_hybrid qshard=batch]"),
        (["--engine", "packed_sharded_hybrid", "--qshard", "2d"], "[packed_sharded_hybrid qshard=2d]"),
        (["--engine", "distributed"], "[distributed]"),
    ],
)
def test_serve_cli_mesh_engines_oneshot(argv, tag, capsys):
    serve.main(["--device", "cpu", *argv, "--n", "4096", "--batch", "256", "--batches", "2"])
    out = capsys.readouterr().out
    assert "1 structure shard(s)" in out and "on 1 shard(s) on 1 device(s) (cpu)" in out
    assert f"{tag} served 512 RMQs" in out and "verify[64] OK" in out


@pytest.mark.parametrize("qshard", [[], ["--qshard"], ["--qshard", "2d"]])
def test_serve_cli_mesh_engines_async(qshard, capsys):
    serve.main(
        ["--device", "cpu", "--mode", "async", "--engine", "sharded_hybrid", *qshard, "--n", "4096",
         "--dist", "medium", "--clients", "2", "--requests", "6", "--req-batch", "16", "--max-batch", "64"]
    )
    out = capsys.readouterr().out
    assert "verify: 12/12 requests bit-identical to the oracle" in out


def test_serve_cli_mesh_flag_validation(capsys):
    with pytest.raises(SystemExit):  # hybrid declares no modes
        serve.main(["--device", "cpu", "--engine", "hybrid", "--qshard", "--n", "1024"])
    assert "--qshard batch requires an engine with a 'shard_batch' mode" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--engine", "distributed", "--qshard", "2d", "--n", "1024"])
    assert "'shard_2d' mode" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--engine", "sharded_hybrid", "--packed", "quantized", "--n", "1024"])
    assert "single-host only" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--engine", "sharded_hybrid", "--mutate", "2", "--n", "1024"])
    assert "--mutate requires --mode async" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--engine", "sharded_hybrid", "--replicas", "3", "--n", "1024"])
    assert "--replicas > 1 requires --mode async" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--mode", "async", "--engine", "lane", "--replicas", "2", "--n", "1024"])
    assert "--replicas > 1 requires an updatable engine" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--engine", "distributed", "--chaos", "1", "--replicas", "2", "--mode", "async"])
    assert "--chaos runs a single-engine soak" in capsys.readouterr().err


# --- serving over an 8-shard mesh --------------------------------------------


@pytest.mark.parametrize("mode", sharded_hybrid.MODES)
def test_two_worker_server_over_8_shard_mesh(mode):
    """Two engine workers launch concurrently over one 8-shard mesh (the
    reference gates such launches on its CPU backend; a single controller
    needs no gate): every request equals the oracle."""
    n = 1 << 14
    x = np.random.default_rng(7).random(n, dtype=np.float32)
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    plan = registry.plan_for_serving("sharded_hybrid", n, mesh=mesh, mode=mode, threshold=128)
    state = build_mod.execute(plan, x)
    spec = registry.get("sharded_hybrid")
    cfg = ServeConfig(deadline_s=0.001, max_batch=64, workers=2, n=n)
    with RMQServer(lambda l, r: spec.query(state, l, r), cfg, warmup_bounds=build_mod.warmup_bounds(plan)) as srv:
        srv.warmup()
        per_client = run_poisson_clients(
            4, 8, 0.0, lambda rng, c: make_queries(rng, n, 24, ("small", "medium")[c % 2]), srv.submit, seed=3
        )
        done = [(l, r, fut.result(timeout=60)) for out in per_client for (l, r), fut in out]
    assert len(done) == 32 and srv.stats().n_batches >= 1
    for l, r, res in done:
        gold = ref.rmq_ref(x, l, r)
        np.testing.assert_array_equal(res.idx, gold)
        np.testing.assert_array_equal(res.val, x[gold])


def test_concurrent_queries_share_one_mesh_state():
    """Threads querying one sharded state at once see their own answers."""
    n = 4096
    x = np.random.default_rng(8).integers(0, 50, n).astype(np.float32)
    s = sharded_hybrid.build(x, _cpu_mesh((2, 4), ("data", "model")), threshold=64, mode="shard_2d")
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(10):
            l, r = _bounded(rng, n, 37)
            idx, _ = sharded_hybrid.query(s, l, r)
            if not np.array_equal(to_np(idx), ref.rmq_ref(x, l, r)):
                errors.append(seed)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and errors == []


@pytest.mark.parametrize("layout", ["packed32", "packed64"])
def test_packed_mesh_online_patch_8_shards(layout):
    """The online packed mesh patch of ``tests/test_packing.py``'s child: a
    min-side value duplicated across shards patches incrementally and equals
    a from-scratch packed build of the mutated array, leaf for leaf."""
    rng = np.random.default_rng(0)
    n = 1 << 11
    x = (rng.integers(-1000, 1000, n).astype(np.int32) if layout == "packed32"
         else rng.standard_normal(n).astype(np.float32))
    mesh = _cpu_mesh()
    eng = update.make_online("sharded_hybrid", x, mesh=mesh, axis_names=("shard",), threshold=64, packed=layout)
    res = eng.apply(update.DeltaLog().point(3, x[5]).point(n - 7, x[5]))
    assert res.patched
    xm = x.copy()
    xm[3] = xm[n - 7] = x[5]
    plan = build_mod.plan_for(
        "sharded_hybrid", n, mesh=mesh, axis_names=("shard",), block_size=128, threshold=64, packed=layout
    )
    fresh = build_mod.execute(plan, xm)
    assert_same_structure((fresh.blocked, fresh.st), (eng.store.current.state.blocked, eng.store.current.state.st))


def test_packed32_growth_past_its_index_field_raises_in_both_packages():
    """A packed32 mesh engine whose key span fills the word: an append past
    the padded capacity needs a wider index field, which no packed32 spec
    can give, so the rebuild raises and the engine fail-stops, in the
    reference (on its one-device mesh) as in the port (8 shards); the
    published version keeps serving."""
    x = np.arange(4096, dtype=np.int32) * 128  # key span 2^19 - 128: 19 bits beside 12 index bits
    tail = np.zeros(5000, np.int32)
    jeng = jax_update.make_online("packed_sharded_hybrid", jnp.asarray(x), packed="packed32")
    with pytest.raises(ValueError, match="packed32 cannot encode"):
        jeng.apply(jax_update.DeltaLog().append(tail))
    eng = update.make_online("packed_sharded_hybrid", x, mesh=_cpu_mesh(), axis_names=("shard",), packed="packed32")
    with pytest.raises(ValueError, match="packed32 cannot encode"):
        eng.apply(update.DeltaLog().append(tail))
    assert eng.poisoned and jeng.poisoned and eng.current_vid == jeng.current_vid == 0
    ver = eng.pin()
    idx, _ = eng.query(ver.state, np.array([0, 100]), np.array([4095, 200]))
    eng.release(ver.vid)
    np.testing.assert_array_equal(to_np(idx), [0, 100])
