"""repro_torch's online updates against the reference's (``tests/test_update.py``).

The mutation-conformance sweep runs every ``updatable`` engine of the port
through every mutation scenario of the reference (point write, range write,
append, write at a block boundary, leftmost-tie flip, n = 1): after each
applied batch the engine answers the numpy oracle of the mutated array, and
at the end its patched state equals a from-scratch port build of that
array leaf for leaf, dtypes included. On the point-write and append
scenarios the port also equals the reference's ``OnlineEngine`` on the same
numpy input: the same leaves after every update, and the same
``UpdateResult`` field for field (the apply time aside), ``publish_bytes``
included. The single-host tests of the reference file follow, on the port,
and a reference snapshot resumes in the port (``convert.online_engine``).
Everything runs on the CPU; tolerance: exact.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import update as jax_update
from repro.core import registry as jax_registry
from repro_torch import convert, update
from repro_torch.core import build as build_mod
from repro_torch.core import ref, registry, sparse_table
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import RMQServer, ServeConfig
from torch_parity_util import assert_same_structure, leaves, to_np


def _bounded(rng, n, b):
    a = rng.integers(0, n, b)
    c = rng.integers(0, n, b)
    return np.minimum(a, c), np.maximum(a, c)


def _online(name, x, **kw):
    return update.make_online(name, x, device="cpu", **kw)


def _rebuild_port(name, x_np, online):
    """A from-scratch port build of the mutated array with the plan params
    the online engine resolved (the hybrids' threshold pinned: a rebuild at
    the new length would re-derive sqrt(n))."""
    n = x_np.shape[0]
    if name in ("hybrid", "packed_hybrid"):
        plan = build_mod.plan_for(
            "hybrid",
            n,
            device="cpu",
            block_size=128,
            threshold=int(online.store.current.state.threshold),
            use_kernels=False,
            packed=online.plan.meta.get("packed"),
        )
        return build_mod.execute(plan, x_np)
    return registry.get(name).build(x_np, device="cpu")


def _query(online, l, r):
    ver = online.pin()
    try:
        return online.query(ver.state, l, r)
    finally:
        online.release(ver.vid)


# --- mutation-conformance sweep ---------------------------------------------
# Each scenario: (initial array, list of (log-building) functions over a
# DeltaLog class, so the same mutations drive both packages).


def _scn_point_write(rng):
    x = rng.integers(0, 4, 700).astype(np.float32)  # tie-heavy
    return x, [lambda L: L().point(123, -3.0), lambda L: L().point(123, 2.0)]


def _scn_range_write(rng):
    x = rng.integers(0, 4, 700).astype(np.float32)
    w = rng.random(50).astype(np.float32)
    return x, [lambda L: L().fill(200, 460, 0.25), lambda L: L().write(10, w)]


def _scn_append(rng):
    x = rng.integers(0, 4, 700).astype(np.float32)
    a1 = rng.integers(0, 4, 150).astype(np.float32)
    a2 = rng.integers(0, 4, 90).astype(np.float32)
    # Append then immediately write into the appended region (coalesces).
    return x, [lambda L: L().append(a1), lambda L: L().append(a2).point(850 + 40, -1.0)]


def _scn_boundary_write(rng):
    """Writes at block boundaries (bs 128/256) — partial-block repair edges."""
    x = rng.integers(0, 4, 1024).astype(np.float32)
    return x, [
        lambda L: L().point(127, -5.0).point(128, -5.0),
        lambda L: L().point(255, -6.0).point(256, -6.0).point(1023, -7.0),
    ]


def _scn_tie_flip(rng):
    """The global min moves LEFT via an equal write: leftmost-tie discipline
    must flip the argmin to the new, earlier copy — and back when it leaves."""
    x = np.ones(700, np.float32)
    x[400] = -2.0
    return x, [lambda L: L().point(100, -2.0), lambda L: L().point(100, 5.0)]


def _scn_n1(rng):
    return np.array([7.0], np.float32), [
        lambda L: L().point(0, -1.0),
        lambda L: L().append(np.array([3.0, 4.0, -9.0], np.float32)),
        lambda L: L().point(2, 8.0),
    ]


SCENARIOS = {
    "point_write": _scn_point_write,
    "range_write": _scn_range_write,
    "append": _scn_append,
    "boundary_write": _scn_boundary_write,
    "tie_flip": _scn_tie_flip,
    "n1": _scn_n1,
}
# Scenarios also held against the reference's OnlineEngine, update by update.
PINNED = ("point_write", "append")


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("engine", registry.updatable_names())
def test_mutation_conformance(engine, scenario):
    rng = np.random.default_rng(sum(map(ord, scenario)))
    x, steps = SCENARIOS[scenario](rng)
    kw = {"threshold": 48} if engine == "hybrid" else {}
    online = _online(engine, x, **kw)
    jonline = jax_update.make_online(engine, jnp.asarray(x), **kw) if scenario in PINNED else None
    xm = x.copy()
    for i, step in enumerate(steps):
        log = step(update.DeltaLog)
        res = online.apply(log)
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        assert res.version == i + 1 and res.n == xm.shape[0] and online.n == res.n
        if jonline is not None:
            jres = jonline.apply(step(jax_update.DeltaLog))
            assert res._replace(seconds=0.0) == jres._replace(seconds=0.0), (res, jres)
            assert_same_structure(jonline.store.current.state, online.store.current.state)
        n = xm.shape[0]
        # Interleaved query after every mutation: random + targeted bounds.
        l, r = _bounded(rng, n, 64)
        l = np.concatenate([l, [0, 0, n - 1]])
        r = np.concatenate([r, [n - 1, 0, n - 1]])
        idx, val = _query(online, l, r)
        gold = ref.rmq_ref(xm, l, r)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(to_np(idx), gold, err_msg=f"{engine}/{scenario}/{i}")
        np.testing.assert_array_equal(to_np(val), xm[gold], err_msg=f"{engine}/{scenario}/{i}")
    # Acceptance criterion: the patched state equals, leaf for leaf, a
    # from-scratch rebuild of the mutated array.
    assert_same_structure(_rebuild_port(engine, xm, online), online.store.current.state)
    np.testing.assert_array_equal(online.store.current.x_host, xm)


def test_apply_validates_batches_before_touching_mirrors():
    """Malformed raw batches are rejected with the engine fully usable."""
    online = _online("sparse_table", np.arange(64.0, dtype=np.float32))
    good = update.DeltaLog().point(1, -1.0).coalesce(64)
    bad = good._replace(idx=np.array([64], np.int64))  # out of range
    with pytest.raises(ValueError):
        online.apply(bad)
    res = online.apply(good)  # NOT fail-stopped: nothing was mutated
    assert res.version == 1
    idx, _ = _query(online, [0], [63])
    assert int(idx[0]) == 1


def test_mid_patch_failure_fail_stops_but_queries_keep_serving(monkeypatch):
    """An exception inside the patch marks the engine failed (later applies
    raise, pointing at the original error) instead of silently publishing a
    diverged version; published versions still answer queries."""
    online = _online("sparse_table", np.arange(32.0, dtype=np.float32))
    online.apply(update.DeltaLog().point(3, -5.0))
    boom = online._impl._replace(
        patch=lambda batch, prev: (_ for _ in ()).throw(RuntimeError("device lost"))
    )
    monkeypatch.setattr(online, "_impl", boom)
    with pytest.raises(RuntimeError, match="device lost"):
        online.apply(update.DeltaLog().point(4, -9.0))
    with pytest.raises(update.EnginePoisoned, match="fail-stopped"):
        online.apply(update.DeltaLog().point(5, -9.0))
    with pytest.raises(update.EnginePoisoned):
        online.snapshot()  # a poisoned engine's mirrors are never persisted
    assert online.current_vid == 1  # nothing published after the failure
    idx, _ = _query(online, [0], [31])
    assert int(idx[0]) == 3


def test_update_result_reports_touched_shards():
    online = _online("sparse_table", np.arange(128.0, dtype=np.float32))
    res = online.apply(update.DeltaLog().point(5, -1.0))
    assert res.touched_shards == 1  # single-host layout: one shard
    # The accounting helper itself distinguishes locality.
    wide = update.DeltaLog().point(1, 0.0).point(100, 0.0).coalesce(128)
    assert len(update.shard_batches(wide, 4, 32)) == 2


def test_registry_updatable_matches_online_implementations():
    assert set(registry.updatable_names()) == set(update.online_names())
    for name in registry.updatable_names():
        assert registry.get(name).serveable  # updatable implies serveable
    # The reference's updatable engines that the port registers: all 8, the
    # three mesh engines among them.
    ported = set(jax_registry.updatable_names()) & set(registry.names())
    mesh = {"distributed", "sharded_hybrid", "packed_sharded_hybrid"}
    assert {name for name in registry.names() if registry.get(name).needs_mesh} == mesh
    assert ported == set(registry.updatable_names())
    assert ported - mesh == {"sparse_table", "block128", "block256", "hybrid", "packed_hybrid"}
    assert len(ported) == 8


def test_non_updatable_engine_rejected():
    with pytest.raises(ValueError, match="not updatable"):
        _online("lane", np.arange(16.0, dtype=np.float32))


@pytest.mark.parametrize("engine", ["distributed", "sharded_hybrid", "packed_sharded_hybrid"])
def test_mesh_engines_patch_copy_on_write(engine):
    """A mesh engine goes online on an 8-shard CPU mesh. A point write in
    shard 5 patches: the answers are the oracle's, a version pinned before
    it keeps its tensors unchanged, and the shards right of the write's
    windows share their tensors with that version, not copies."""
    mesh = make_mesh((8,), ("shard",), devices="cpu")
    x = np.random.default_rng(3).integers(0, 4, 4096).astype(np.float32)
    kw = {"packed": "packed64"} if engine == "packed_sharded_hybrid" else {}
    online = update.make_online(engine, x, mesh=mesh, axis_names=("shard",), **kw)
    assert online.mesh is mesh and online.device == torch.device("cpu")
    old = online.pin()
    before = [(p, to_np(a).copy()) for p, a in leaves(old.state)]
    res = online.apply(update.DeltaLog().point(5 * 512 + 3, -9.0))
    assert res.patched and res.touched_shards == 1
    for (p, a), (_, b) in zip(before, leaves(old.state)):
        np.testing.assert_array_equal(a, to_np(b), err_msg=p)
    new = online.store.current.state
    first = (lambda s: s[0]) if engine == "distributed" else (lambda s: s.blocked)
    blocked_old, blocked_new = first(old.state), first(new)
    leaf = blocked_old.blocks if engine == "packed_sharded_hybrid" else blocked_old.x_blocks
    leaf_new = blocked_new.blocks if engine == "packed_sharded_hybrid" else blocked_new.x_blocks
    assert leaf_new.part(6) is leaf.part(6) and leaf_new.part(5) is not leaf.part(5)
    online.release(old.vid)
    xm = x.copy()
    xm[5 * 512 + 3] = -9.0
    l, r = _bounded(np.random.default_rng(4), 4096, 128)
    idx, val = _query(online, l, r)
    gold = ref.rmq_ref(xm, l, r)
    np.testing.assert_array_equal(to_np(idx), gold)
    np.testing.assert_array_equal(to_np(val), xm[gold])


def test_online_placement_is_checked():
    x = np.arange(16.0, dtype=np.float32)
    mesh = make_mesh((2,), ("shard",), devices="cpu")
    with pytest.raises(ValueError, match="one device"):
        update.make_online("hybrid", x, mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        update.make_online("sharded_hybrid", x, mesh=mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            update.make_online("sharded_hybrid", x)  # the card's mesh by default: no CPU fallback


# --- delta log --------------------------------------------------------------


def test_delta_log_coalesce_last_write_wins():
    log = update.DeltaLog().point(3, 1.0).fill(2, 5, 7.0).point(3, 9.0)
    b = log.coalesce(10)
    np.testing.assert_array_equal(b.idx, [2, 3, 4, 5])
    np.testing.assert_array_equal(b.val, [7.0, 9.0, 7.0, 7.0])
    assert b.tail.size == 0 and b.n_old == 10 and b.n_new == 10
    xm = b.apply_numpy(np.zeros(10, np.float32))
    np.testing.assert_array_equal(xm[2:6], [7, 9, 7, 7])


def test_delta_log_append_then_write_folds_into_tail():
    log = update.DeltaLog().append([1.0, 2.0, 3.0]).point(11, 8.0).fill(9, 10, 4.0)
    b = log.coalesce(10)
    assert b.n_new == 13 and b.n_old == 10
    np.testing.assert_array_equal(b.idx, [9])  # the in-prefix part of the fill
    np.testing.assert_array_equal(b.val, [4.0])
    np.testing.assert_array_equal(b.tail, [4.0, 8.0, 3.0])  # writes folded in
    np.testing.assert_array_equal(b.touched(), [9, 10, 11, 12])


def test_delta_log_rejects_out_of_range_and_empty():
    with pytest.raises(ValueError):
        update.DeltaLog().point(10, 1.0).coalesce(10)  # past the end
    with pytest.raises(ValueError):
        update.DeltaLog().fill(8, 12, 1.0).coalesce(10)  # straddles the end
    with pytest.raises(ValueError):
        update.DeltaLog().coalesce(10)  # empty log
    with pytest.raises(ValueError):
        update.DeltaLog().point(-1, 0.0)
    with pytest.raises(ValueError):
        update.DeltaLog().append(np.zeros(0))
    # Appends extend the writable range in arrival order.
    update.DeltaLog().append([1.0, 2.0]).point(11, 5.0).coalesce(10)


def test_shard_batches_groups_by_owner():
    b = update.DeltaLog().point(1, 1.0).point(130, 2.0).point(131, 3.0).coalesce(512)
    per = update.shard_batches(b, num_shards=4, shard_len=128)
    assert [(s, list(p)) for s, p, _ in per] == [(0, [1]), (1, [130, 131])]
    np.testing.assert_array_equal(per[1][2], [2.0, 3.0])


# --- patch kernels (host mirrors) -------------------------------------------


def test_level_windows_merge_and_clip():
    assert update.level_windows(np.array([5]), 3, 100) == [(2, 5)]
    assert update.level_windows(np.array([1, 5, 50]), 3, 100) == [(0, 5), (47, 50)]
    assert update.level_windows(np.array([0]), 7, 100) == [(0, 0)]


def test_level_windows_match_the_reference_loop():
    """The vectorized merge equals the reference's loop on sorted positions
    (duplicates, positions past the end, runs that touch and runs that do
    not), every width."""
    from repro.update.patch import level_windows as jax_level_windows

    rng = np.random.default_rng(12)
    for _ in range(300):
        m = int(rng.integers(1, 400))
        touched = np.sort(rng.integers(0, m + 20, int(rng.integers(1, 40))))
        w = int(rng.integers(0, 70))
        assert update.level_windows(touched, w, m) == jax_level_windows(touched, w, m), (touched, w, m)
    fill = np.arange(1_000_000, 11_000_000)  # a fill of ten million values: one window
    assert update.level_windows(fill, 1023, 1 << 26) == [(1_000_000 - 1023, 10_999_999)]


def test_patch_doubling_matches_build_for_scattered_writes():
    rng = np.random.default_rng(3)
    x = rng.random(257).astype(np.float32)
    idx = to_np(sparse_table.build(torch.from_numpy(x)).idx).copy()
    x[7] = -1.0
    x[200] = -1.0  # tied pair, far apart: two windows per level
    out = update.patch_doubling(idx, x, np.array([7, 200]), 257)
    np.testing.assert_array_equal(out, to_np(sparse_table.build(torch.from_numpy(x)).idx))


def test_patch_doubling_append_grows_levels():
    x = np.arange(4, 0, -1).astype(np.float32)  # n=4: K=3
    idx = to_np(sparse_table.build(torch.from_numpy(x)).idx).copy()
    x2 = np.concatenate([x, np.array([-5.0, 9.0], np.float32)])  # n=6: K=4
    out = update.patch_doubling(idx, x2, np.array([4, 5]), 4)
    want = to_np(sparse_table.build(torch.from_numpy(x2)).idx)
    assert out.shape == want.shape == (4, 6)
    np.testing.assert_array_equal(out, want)


# --- MVCC version store ------------------------------------------------------


def test_version_store_pin_publish_retire():
    store = update.VersionStore()
    store.publish("v0-state", 10)
    v0 = store.pin()
    assert (v0.vid, v0.state, v0.n) == (0, "v0-state", 10)
    assert store.publish("v1-state", 11) == 1
    assert store.live_vids() == (0, 1)  # v0 still pinned
    assert store.current.state == "v1-state"
    store.release(0)
    assert store.live_vids() == (1,)  # drained -> retired
    with pytest.raises(ValueError):
        store.release(0)  # double release


def test_version_store_retires_unpinned_superseded_immediately():
    store = update.VersionStore()
    store.publish("a", 1)
    store.publish("b", 1)
    assert store.live_vids() == (1,)


def test_version_store_errors_before_first_publish():
    store = update.VersionStore()
    with pytest.raises(RuntimeError):
        store.pin()


# --- update plan stages -------------------------------------------------------


def test_update_lowered_through_apply_deltas_and_publish_stages():
    online = _online("sparse_table", np.arange(64.0, dtype=np.float32))
    seen = []
    res = online.apply(
        update.DeltaLog().point(5, -1.0),
        observer=lambda stage, state: seen.append(stage),
    )
    assert seen == ["apply_deltas", "publish"]
    assert res.patched and res.n_writes == 1 and res.n_appended == 0
    assert [build_mod.STAGE_NAMES.index(s) for s in seen] == sorted(
        build_mod.STAGE_NAMES.index(s) for s in seen
    )


def test_apply_rejects_stale_batch():
    online = _online("sparse_table", np.arange(32.0, dtype=np.float32))
    stale = update.DeltaLog().point(1, 0.5).coalesce(31)  # wrong length
    with pytest.raises(ValueError):
        online.apply(stale)


# --- serving: snapshot isolation ---------------------------------------------


def test_snapshot_isolation_inflight_query_sees_pinned_version():
    """A query flushed (pinned) before an update publishes must be answered
    against its snapshot even though the engine executes it afterwards."""
    x = np.arange(64, 0, -1).astype(np.float32)  # argmin = 63
    online = _online("sparse_table", x)
    gate = threading.Event()
    real_query = online.query

    def gated(state, l, r):
        gate.wait(30)
        return real_query(state, l, r)

    online.query = gated
    srv = RMQServer(online=online, config=ServeConfig(deadline_s=0.0, n=64)).start()
    try:
        fut = srv.submit(np.array([0], np.int32), np.array([63], np.int32))
        deadline = time.time() + 10  # wait for the flush to pin version 0
        while not online.store._pins and time.time() < deadline:
            time.sleep(0.005)
        assert online.store._pins, "batch never pinned a version"
        # Publish version 1 while the query is in flight (new global min).
        online.apply(update.DeltaLog().point(5, -100.0))
        assert online.current_vid == 1
        gate.set()
        res = fut.result(timeout=30)
        assert res.version == 0
        assert res.idx[0] == 63 and res.val[0] == 1.0  # the OLD argmin
        # A fresh query sees the new version.
        res2 = srv.submit(np.array([0], np.int32), np.array([63], np.int32)).result(timeout=30)
        assert res2.version == 1 and res2.idx[0] == 5
    finally:
        gate.set()
        srv.close()
    st = srv.stats()
    assert st.version_lags == (1, 0) and st.version_lag_max == 1
    assert online.store.live_vids() == (1,)  # v0 drained and retired


# --- windowed copy-on-write publish ------------------------------------------


def test_windowed_cow_publish_tracks_patch_windows():
    """A point write uploads only the patched windows — far less than the
    structure — while appends that grow the leaves re-upload in full; the
    byte counts equal the reference's on the same input."""
    n = 4096
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    for engine in ("sparse_table", "block128", "hybrid"):
        online = _online(engine, x)
        jonline = jax_update.make_online(engine, jnp.asarray(x))
        full_bytes = sum(to_np(a).nbytes for _, a in leaves(online.store.current.state))
        res = online.apply(update.DeltaLog().point(n // 2, -123.0))
        jres = jonline.apply(jax_update.DeltaLog().point(n // 2, -123.0))
        assert res.patched
        assert 0 < res.publish_bytes < full_bytes // 4, (engine, res.publish_bytes, full_bytes)
        assert res.publish_bytes == jres.publish_bytes
        # Growth changes leaf shapes: the publish re-uploads in full, and the
        # byte count says so (no silent undercount).
        tail = np.full(8, 9.0, np.float32)
        res2 = online.apply(update.DeltaLog().append(tail))
        jres2 = jonline.apply(jax_update.DeltaLog().append(tail))
        assert res2.publish_bytes > res.publish_bytes
        assert res2.publish_bytes == jres2.publish_bytes


def test_windowed_cow_publish_preserves_old_versions():
    """COW at the leaf level: a pinned old version keeps answering from its
    own tensors after windowed publishes write new ones, and no leaf tensor
    is shared with the host mirrors."""
    n = 1024
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    online = _online("sparse_table", x)
    ver0 = online.pin()
    before = [to_np(a).copy() for _, a in leaves(ver0.state)]
    online.apply(update.DeltaLog().fill(0, 255, -50.0))
    l = np.array([0], np.int32)
    r = np.array([n - 1], np.int32)
    idx0, _ = online.query(ver0.state, l, r)
    assert int(idx0[0]) == int(np.argmin(x))  # pre-update oracle
    for a, (_, b) in zip(before, leaves(ver0.state)):
        np.testing.assert_array_equal(a, to_np(b))  # never written
    ver1 = online.pin()
    idx1, _ = online.query(ver1.state, l, r)
    assert 0 <= int(idx1[0]) <= 255  # the fill owns the minimum now
    online.release(ver0.vid)
    online.release(ver1.vid)


# --- snapshots: the reference's state resumes in the port ---------------------


@pytest.mark.parametrize(
    "engine,kw",
    [
        ("sparse_table", {}),
        ("block256", {}),
        ("hybrid", {"threshold": 48}),
        ("packed_hybrid", {"packed": "quantized"}),
    ],
)
def test_reference_snapshot_resumes_in_the_port(engine, kw):
    """A reference engine that has taken updates snapshots; the snapshot
    (numpy arrays and JSON meta, unchanged) loads through
    ``convert.online_engine`` and continues at the same vid with the same
    leaves and answers, then both take one more update alike. The port's own
    snapshot of the resumed engine equals the reference's."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 9, 900).astype(np.float32)
    jonline = jax_update.make_online(engine, jnp.asarray(x), **kw)
    xm = x.copy()
    for step in (lambda L: L().point(17, -4.0), lambda L: L().append(np.full(40, -1.0, np.float32))):
        log = step(jax_update.DeltaLog)
        jonline.apply(log)
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
    arrays, meta = jonline.snapshot()
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    online = convert.online_engine(arrays, meta, device="cpu")
    assert online.current_vid == jonline.current_vid == 2 and online.n == xm.shape[0]
    assert_same_structure(jonline.store.current.state, online.store.current.state)
    l, r = _bounded(rng, xm.shape[0], 100)
    gold = ref.rmq_ref(xm, l, r)
    idx, val = _query(online, l, r)
    np.testing.assert_array_equal(to_np(idx), gold)
    np.testing.assert_array_equal(to_np(val), xm[gold])
    res = online.apply(update.DeltaLog().fill(100, 300, -7.0))
    jres = jonline.apply(jax_update.DeltaLog().fill(100, 300, -7.0))
    assert res._replace(seconds=0.0) == jres._replace(seconds=0.0) and res.version == 3
    assert_same_structure(jonline.store.current.state, online.store.current.state)
    parrays, pmeta = online.snapshot()
    jarrays, jmeta = jonline.snapshot()
    assert pmeta == jmeta
    assert sorted(parrays) == sorted(jarrays)
    for k in jarrays:
        assert parrays[k].dtype == np.asarray(jarrays[k]).dtype, k
        np.testing.assert_array_equal(parrays[k], np.asarray(jarrays[k]), err_msg=k)
