"""repro_torch's replica fleet against the reference's (``tests/test_fleet.py``).

The 13 tests of the reference file, under the same names, on the port:
rollout propagation, bounded lag, read-your-writes, regime routing and
crash -> restore -> rejoin, each query held to the host oracle of the
version it was answered at. The reference's 8-device child runs in-process
on 8 CPU positions (``devices=["cpu"] * 8``: three replicas of two). Where
the reference waits with a sleep, these tests wait on the rollout tracker,
a thread or an event. Then the deterministic parts against the reference
itself: ``FleetConfig``'s validation messages and affinities,
``_classify`` on the same batches, ``submit(min_version=)`` and
``StaleVersion``, and the warmup order of a long-affinity server; the
reference's threaded fleet is not run. Everything runs on the CPU;
tolerance: exact.
"""

import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import update as jax_update
from repro.serve import RMQServer as JaxServer
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import StaleVersion as JaxStaleVersion
from repro.serve import fleet as jax_fleet
from repro_torch.fault.inject import FaultPlan, FaultSpec
from repro_torch.launch import serve
from repro_torch.serve import RMQServer, ServeConfig, StaleVersion
from repro_torch.serve.fleet import (
    FleetConfig,
    FleetSession,
    RMQFleet,
    cli_placement,
    parse_devices,
    run_fleet_soak,
)
from repro_torch.update import DeltaLog, make_online

N = 2048
CPU = {"device": "cpu"}


def _x(seed=0, n=N):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _cfg(**kw):
    kw.setdefault("replicas", 3)
    kw.setdefault("max_version_lag", 2)
    kw.setdefault("server", ServeConfig(workers=1, deadline_s=2e-4, max_retries=8))
    return FleetConfig(**kw)


def _fleet(x, config, **kw):
    return RMQFleet.build("hybrid", x, config=config, **CPU, **kw)


def _point(i, v):
    log = DeltaLog()
    log.point(i, v)
    return log


def _verify(res, ox, l, r):
    for j in range(l.size):
        seg = ox[l[j] : r[j] + 1]
        assert res.idx[j] == l[j] + int(np.argmin(seg))


# --- config ------------------------------------------------------------------


def test_fleet_config_validation():
    with pytest.raises(ValueError):
        FleetConfig(replicas=0)
    with pytest.raises(ValueError):
        FleetConfig(max_version_lag=0)
    with pytest.raises(ValueError):
        FleetConfig(replicas=2, affinities=("short",))  # wrong arity
    with pytest.raises(ValueError):
        FleetConfig(replicas=2, affinities=("short", "sideways"))
    assert FleetConfig(replicas=4).resolved_affinities() == ("short", "long", "short", "long")
    assert FleetConfig(replicas=1).resolved_affinities() == (None,)


def test_session_floor_is_monotonic():
    s = FleetSession()
    assert s.last_vid == -1
    s.observe(3)
    s.observe(1)  # stale observation must not lower the floor
    assert s.last_vid == 3


# --- rollouts ----------------------------------------------------------------


def test_rollout_reaches_every_replica_and_respects_lag_bound():
    x = _x()
    fleet = _fleet(x, _cfg())
    try:
        cur = x.copy()
        expected = {fleet.head_vid: cur.copy()}
        for k in range(6):
            i, v = 37 * (k + 1) % N, float(-10.0 - k)
            res = fleet.submit_update(_point(i, v)).result(timeout=60)
            cur[i] = np.float32(v)
            expected[res.version] = cur.copy()
        assert fleet.wait_settled(timeout=60)
        head = fleet.head_vid
        assert head == 6
        # Every replica converged to the head and vids stayed aligned.
        for rep in fleet.replicas:
            assert rep.active
            assert rep.engine.current_vid == head
        assert fleet.tracker.max_lag_seen <= fleet.config.max_version_lag
        # Each replica answers the head oracle through its own server.
        rng = np.random.default_rng(1)
        l = rng.integers(0, N, 16).astype(np.int32)
        r = np.minimum(N - 1, l + rng.integers(0, N // 2, 16)).astype(np.int32)
        for rep in fleet.replicas:
            res = rep.server.submit(l, r, min_version=head).result(timeout=60)
            assert res.version == head
            _verify(res, expected[head], l, r)
    finally:
        fleet.close()


def test_update_future_resolves_at_first_publish_and_raises_session_floor():
    fleet = _fleet(_x(), _cfg())
    try:
        sess = fleet.session()
        res = fleet.submit_update(_point(5, -50.0), session=sess).result(timeout=60)
        assert res.version == 1
        # The ack point moved the floor before the future resolved.
        assert sess.last_vid == 1
    finally:
        fleet.close()


def test_append_rollout_raises_routing_floor():
    x = _x()
    fleet = _fleet(x, _cfg(replicas=2))
    try:
        tail = np.full(8, -99.0, np.float32)
        log = DeltaLog()
        log.append(tail)
        res = fleet.submit_update(log).result(timeout=60)
        grown = np.concatenate([x, tail])
        # A query past the old length is only valid at the grown version; the
        # front door must route it to a replica that has published it.
        l = np.array([0], np.int32)
        r = np.array([grown.shape[0] - 1], np.int32)
        out = fleet.submit(l, r).result(timeout=60)
        assert out.version >= res.version
        _verify(out, grown, l, r)
        # Beyond the head is a client error, not a routing wait.
        with pytest.raises(ValueError):
            fleet.submit(l, np.array([grown.shape[0]], np.int32))
    finally:
        fleet.close()


def test_read_your_writes_under_forced_lag():
    """One replica's applies are held back until the session has read all
    three of its writes: each read must route to the fresh replica, at or
    past the session's floor, and see the write."""
    x = _x()
    fleet = _fleet(x, _cfg(replicas=2, max_version_lag=4))
    gate = threading.Event()
    try:
        slow = fleet.replicas[1].engine
        real_apply = slow.apply

        def held_apply(deltas, **kw):
            assert gate.wait(timeout=60)
            return real_apply(deltas, **kw)

        slow.apply = held_apply  # instance attribute shadows the bound method
        sess = fleet.session()
        cur = x.copy()
        for k in range(3):
            i, v = 101 * (k + 1) % N, float(-20.0 - k)
            res = fleet.submit_update(_point(i, v), session=sess).result(timeout=60)
            cur[i] = np.float32(v)
            assert sess.last_vid == res.version
            l = np.array([max(0, i - 3)], np.int32)
            r = np.array([min(N - 1, i + 3)], np.int32)
            out = fleet.submit(l, r, session=sess).result(timeout=60)
            # Never answered below the session floor, and correct at its
            # version (which must include the session's own write).
            assert out.version >= res.version
            _verify(out, cur, l, r)
        assert slow.current_vid == 0  # the lag was real: replica 1 still at v0
        gate.set()
        assert fleet.wait_settled(timeout=60)
    finally:
        gate.set()
        fleet.close()


# --- regime routing ----------------------------------------------------------


def test_regime_routing_prefers_affinity_pools():
    x = _x()
    fleet = _fleet(x, _cfg(replicas=2, threshold=32), threshold=32)
    try:
        assert fleet.threshold == 32
        assert [rep.affinity for rep in fleet.replicas] == ["short", "long"]
        rng = np.random.default_rng(2)
        for _ in range(8):  # clearly short batches: lengths <= 8
            l = rng.integers(0, N - 8, 4).astype(np.int32)
            r = (l + rng.integers(0, 8, 4)).astype(np.int32)
            _verify(fleet.submit(l, r).result(timeout=60), x, l, r)
        for _ in range(8):  # clearly long batches: lengths >= 256
            l = rng.integers(0, N - 512, 4).astype(np.int32)
            r = (l + 256 + rng.integers(0, 256, 4)).astype(np.int32)
            _verify(fleet.submit(l, r).result(timeout=60), x, l, r)
        st = fleet.stats()
        assert st.requests == 16
        assert st.affinity_hits == 16 and st.affinity_misses == 0
        assert st.routed == (8, 8)  # short pool got the short half, long the long
    finally:
        fleet.close()


def test_majority_regime_classifies_mixed_batches():
    fleet = _fleet(_x(), _cfg(replicas=2, threshold=32))
    try:
        l = np.zeros(3, np.int32)
        assert fleet._classify(l, np.array([1, 2, 500], np.int32)) == "short"
        assert fleet._classify(l, np.array([1, 500, 600], np.int32)) == "long"
    finally:
        fleet.close()


# --- crash / restore ---------------------------------------------------------


def _join_revivals(fleet, replicas):
    """Wait until ``replicas`` replicas are registered again, then join the
    revive threads (each bumps the fleet's restore count last)."""
    assert fleet.tracker.wait_for(lambda vids: len(vids) == replicas, timeout=60)
    for t in threading.enumerate():
        if t.name.startswith("fleet-revive-"):
            t.join(timeout=60)
            assert not t.is_alive()


def test_mid_rollout_crash_auto_revives_with_vid_continuity(tmp_path):
    """The rollout_apply fault kills one replica mid-rollout; auto-revive
    restores it from its WAL (checkpoint + journal, then fleet-history
    catch-up) and it rejoins at the fleet head with its vid timeline
    intact."""
    x = _x()
    # 4th check = first replica picking up rollout 2 (3 replicas).
    plan = FaultPlan(0, {"rollout_apply": FaultSpec(at=(4,))})
    fleet = _fleet(x, _cfg(), durable_root=str(tmp_path), fault_plan=plan)
    try:
        cur = x.copy()
        expected = {0: cur.copy()}
        for k in range(5):
            i, v = 53 * (k + 1) % N, float(-30.0 - k)
            res = fleet.submit_update(_point(i, v)).result(timeout=60)
            cur[i] = np.float32(v)
            expected[res.version] = cur.copy()
        assert plan.fired()["rollout_apply"] == 1
        _join_revivals(fleet, 3)
        st = fleet.stats()
        assert st.crashes == 1 and st.restores == 1 and st.active == 3
        assert fleet.wait_settled(timeout=60)
        head = fleet.head_vid
        for rep in fleet.replicas:
            # first_vid continuity: the restored engine continued the SAME
            # timeline (vid == number of rollouts), not a fresh one from 0.
            assert rep.engine.current_vid == head == 5
        l = np.arange(0, 64, dtype=np.int32)
        r = l + 32
        for rep in fleet.replicas:
            res = rep.server.submit(l, r, min_version=head).result(timeout=60)
            _verify(res, expected[head], l, r)
    finally:
        fleet.close()


def test_external_crash_then_restore_catches_up_from_history(tmp_path):
    x = _x()
    fleet = _fleet(x, _cfg(), durable_root=str(tmp_path))
    try:
        cur = x.copy()
        fleet.submit_update(_point(7, -40.0)).result(timeout=60)
        cur[7] = np.float32(-40.0)
        assert fleet.wait_settled(timeout=60)
        fleet.crash_replica(1)
        assert not fleet.replicas[1].active
        assert 1 not in fleet.tracker.vids()  # dead keys can't wedge the barrier
        # Updates continue without the dead replica (fanout excludes it).
        for k in range(3):
            i, v = 211 * (k + 1) % N, float(-41.0 - k)
            fleet.submit_update(_point(i, v)).result(timeout=60)
            cur[i] = np.float32(v)
        assert fleet.wait_settled(timeout=60)
        fleet.restore_replica(1)
        rep = fleet.replicas[1]
        assert rep.active and rep.restores == 1
        assert rep.engine.current_vid == fleet.head_vid == 4
        l = np.array([0], np.int32)
        r = np.array([N - 1], np.int32)
        res = rep.server.submit(l, r, min_version=4).result(timeout=60)
        _verify(res, cur, l, r)
        # And it takes part in the next rollout normally.
        fleet.submit_update(_point(3, -99.0)).result(timeout=60)
        cur[3] = np.float32(-99.0)
        assert fleet.wait_settled(timeout=60)
        assert rep.engine.current_vid == 5
    finally:
        fleet.close()


def test_restore_replica_requires_durable_root():
    fleet = _fleet(_x(), _cfg(replicas=2))
    try:
        fleet.crash_replica(1)
        with pytest.raises(RuntimeError):
            fleet.restore_replica(1)
        # The in-memory fleet keeps serving on the survivor.
        l = np.array([0], np.int32)
        out = fleet.submit(l, np.array([100], np.int32)).result(timeout=60)
        assert out.idx.shape == (1,)
    finally:
        fleet.close()


# --- acceptance soak ---------------------------------------------------------


def test_fleet_soak_in_process():
    """The soak, scaled down: mutate-while-serving with an injected
    mid-rollout crash AND an external crash + restore; zero lost, zero
    mismatches, zero RYW violations, lag within bound."""
    report = run_fleet_soak(engine="hybrid", replicas=3, n=1 << 11, requests=60, updates=4, seed=3, **CPU)
    assert report.ok, report.summary()
    assert report.crashes >= 2 and report.restores >= 2


def test_sharded_fleet_on_8_device_mesh():
    """3 sharded_hybrid replicas on disjoint groups of 8 CPU positions (two
    each): full soak with crash + restore, oracle-verified."""
    report = run_fleet_soak(
        engine="sharded_hybrid", replicas=3, n=4096, requests=48, updates=4, qbatch=4, seed=1, max_lag=2,
        devices=["cpu"] * 8,
    )
    assert report.ok, report.summary()


# --- placement ---------------------------------------------------------------


def test_fleet_device_groups():
    """A mesh engine's replicas carve the given positions into equal
    disjoint groups; a single-device engine takes ``device``, not
    ``devices``, and a mesh engine the reverse; without CUDA the default
    placement raises."""
    x = _x(n=1024)
    fleet = RMQFleet.build("distributed", x, config=_cfg(), devices=parse_devices("cpu*7"))
    try:
        assert [rep.mesh.size for rep in fleet.replicas] == [2, 2, 2]
        assert all(rep.mesh.physical_devices == (torch.device("cpu"),) for rep in fleet.replicas)
        assert all(rep.engine.mesh is rep.mesh for rep in fleet.replicas)
    finally:
        fleet.close()
    with pytest.raises(ValueError, match="3 replicas need >= 3 devices"):
        RMQFleet.build("sharded_hybrid", x, config=_cfg(), devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="devices= carves mesh replicas"):
        RMQFleet.build("hybrid", x, config=_cfg(), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="device= is for one-device engines"):
        RMQFleet.build("sharded_hybrid", x, config=_cfg(), **CPU)
    assert cli_placement("sharded_hybrid", "cpu", None, 3) == {"devices": ["cpu"] * 3}
    assert cli_placement("sharded_hybrid", "cuda", None, 3) == {"devices": None}
    assert cli_placement("distributed", "cpu", ["cpu"] * 8, 3) == {"devices": ["cpu"] * 8}
    assert cli_placement("hybrid", "cpu", None, 3) == {"device": "cpu", "devices": None}
    with pytest.raises(ValueError, match="updatable engine; 'lane' is not"):
        RMQFleet.build("lane", x, config=_cfg(), **CPU)
    if not torch.cuda.is_available():
        for engine in ("hybrid", "sharded_hybrid"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                RMQFleet.build(engine, x, config=_cfg())
    assert parse_devices("cuda:0*2,cpu") == ["cuda:0", "cuda:0", "cpu"]


def test_serve_cli_fleet(capsys):
    """``--replicas 3 --max-lag 2 --mutate 4`` through the serve CLI: every
    request equal to the oracle of its version, the fleet settled."""
    serve.main(["--device", "cpu", "--mode", "async", "--engine", "hybrid", "--replicas", "3", "--max-lag", "2",
                "--mutate", "4", "--n", "8192", "--clients", "2", "--requests", "8", "--req-batch", "32"])
    out = capsys.readouterr().out
    assert "verify: 16/16 requests bit-identical" in out and "settled=True" in out
    assert "affinities ['short', 'long', 'short']" in out


# --- the deterministic parts against the reference ---------------------------


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize(
    "kw",
    [
        {"replicas": 0},
        {"max_version_lag": 0},
        {"route_timeout_s": 0.0},
        {"max_route_retries": -1},
        {"replicas": 2, "affinities": ("short",)},
        {"replicas": 2, "affinities": ("short", "sideways")},
    ],
)
def test_fleet_config_messages_match_reference(kw):
    assert _message(lambda: FleetConfig(**kw)) == _message(lambda: jax_fleet.FleetConfig(**kw))


def test_resolved_affinities_match_reference():
    for replicas in range(1, 6):
        assert FleetConfig(replicas=replicas).resolved_affinities() == jax_fleet.FleetConfig(
            replicas=replicas
        ).resolved_affinities()
    affs = ("long", None, "short")
    assert FleetConfig(replicas=3, affinities=affs).resolved_affinities() == affs


def test_classify_matches_reference():
    rng = np.random.default_rng(9)
    for thr in (1, 32, 700):
        for _ in range(50):
            b = int(rng.integers(0, 9))
            l = rng.integers(0, 4096, b).astype(np.int32)
            r = (l + rng.integers(0, 2 * thr, b)).astype(np.int32)
            got = RMQFleet._classify(SimpleNamespace(_threshold=thr), l, r)
            assert got == jax_fleet.RMQFleet._classify(SimpleNamespace(_threshold=thr), l, r)


def test_min_version_and_stale_version_match_reference():
    x = _x(n=256)
    l, r = np.array([0, 5], np.int32), np.array([255, 9], np.int32)
    servers = (
        RMQServer(online=make_online("sparse_table", x, **CPU), config=ServeConfig(deadline_s=0.0)),
        JaxServer(online=jax_update.make_online("sparse_table", jnp.asarray(x)), config=JaxServeConfig(deadline_s=0.0)),
    )
    msgs = []
    for srv, stale in zip(servers, (StaleVersion, JaxStaleVersion)):
        with srv:
            with pytest.raises(stale) as e:
                srv.submit(l, r, min_version=1)
            msgs.append(str(e.value))
            res = srv.submit(l, r, min_version=0).result(timeout=60)
            assert res.version == 0
            _verify(res, x, l, r)
            log = _point(3, -9.0) if stale is StaleVersion else jax_update.DeltaLog().point(3, -9.0)
            assert srv.submit_update(log).result(timeout=60).version == 1
            assert srv.submit(l, r, min_version=1).result(timeout=60).version == 1
    assert msgs[0] == msgs[1] == "server at version 0, request requires >= 1"
    bare = (
        RMQServer(lambda a, b: (a, a.astype(np.float32)), ServeConfig(n=8)),
        JaxServer(lambda a, b: (a, a.astype(np.float32)), JaxServeConfig(n=8)),
    )
    assert [_message(lambda s=s: s.start().submit(l[:1] * 0, l[:1] * 0, min_version=0)) for s in bare] == [
        "min_version needs a server with an OnlineEngine"
    ] * 2
    for s in bare:
        s.close()
    assert _message(lambda: ServeConfig(regime_affinity="sideways")) == _message(
        lambda: JaxServeConfig(regime_affinity="sideways")
    )


def test_long_affinity_warms_its_regime_first():
    """A ``"long"`` server runs each size's long probe before its short one,
    as the reference's does; the others keep the plan's order."""
    bounds = lambda s: [(np.zeros(s, np.int32), np.full(s, 3, np.int32)), (np.zeros(s, np.int32), np.full(s, 99, np.int32))]
    for affinity in (None, "short", "long"):
        calls = []

        def record(l, r):
            calls.append(int(r[0]))
            return l, l.astype(np.float32)

        for pkg_server, pkg_cfg in ((RMQServer, ServeConfig), (JaxServer, JaxServeConfig)):
            srv = pkg_server(record, pkg_cfg(regime_affinity=affinity), warmup_bounds=bounds)
            assert srv.affinity == affinity
            srv.warmup([1, 2])
        want = [99, 3] if affinity == "long" else [3, 99]
        assert calls == (want * 2) * 2


def test_block_oracle_matches_a_scan():
    """The soak's oracle (whole-block minima plus two end scans) answers
    ``l + argmin(x[l:r+1])`` on tie-heavy arrays with signed zeros, at
    lengths around its block size."""
    from repro_torch.serve.fleet import _BlockOracle

    rng = np.random.default_rng(0)
    for n in (1, 5, 1024, 1025, 5000, 70000):
        x = rng.integers(0, 3, n).astype(np.float32)
        x[rng.integers(0, n, 3)] = -0.0
        oracle = _BlockOracle(x)
        for _ in range(500):
            l = int(rng.integers(0, n))
            r = int(rng.integers(l, n))
            assert oracle.argmin(l, r) == l + int(np.argmin(x[l : r + 1]))


def test_soak_reports_rollout_and_request_latencies():
    report = run_fleet_soak(engine="hybrid", replicas=2, n=1 << 11, requests=24, updates=3, seed=5, **CPU)
    assert report.ok, report.summary()
    assert len(report.first_publish_s) == len(report.last_publish_s) == report.updates > 0
    assert all(0 < a <= b for a, b in zip(report.first_publish_s, report.last_publish_s))
    assert 0 < report.request_p50_s <= report.request_p99_s
    assert "to first publish" in report.latency_summary()
