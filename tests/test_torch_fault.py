"""repro_torch's crash safety against the reference's (``tests/test_fault.py``).

Every scenario of the reference file, one for one and under the same
name, on the port: the fault plan, the journal (round trip, abort markers,
torn tail, compaction, an injected append failure), ``DeltaBatch`` bytes
(equal to the reference's), restore = checkpoint + journal suffix
bit-identical for every updatable engine, the torn journal tail, the failed
checkpoint, the poisoned engine's recovery, the supervised server's cases
and ``RMQServer(restore=)``. The reference's 8-device child
(``test_sharded_durable_restore_on_8_device_mesh``) runs in-process on an
8-shard CPU mesh. Covered elsewhere and not repeated here:
``test_degraded_fallback_matches_oracle`` by
``tests/test_torch_online_serve.py::test_online_breaker_answers_through_the_degraded_fallback``.

Then the durable root across packages, for each of the eight updatable
engines: the same timeline (two updates, a mid checkpoint, an injected
apply failure with its abort marker and recovery, the update again, an
append) written by each package gives the same journal and checkpoint files
byte for byte, a root the reference wrote restores in the port and one the
port wrote restores in the reference, leaf for leaf with the same version
id, seq and replay count. The port runs a mesh engine on an 8-shard CPU
mesh, the reference in-process on its one-device mesh: a mesh engine's
root is its array, so it does not depend on the mesh. Everything runs on
the CPU; tolerance: exact.
"""

import os
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from repro import fault as jax_fault
from repro import update as jax_update
from repro.update.deltas import DeltaLog as JaxDeltaLog
from repro_torch import checkpoint as ckpt_mod
from repro_torch import update
from repro_torch.core import ref, registry
from repro_torch.fault import DurableEngine, FaultPlan, FaultSpec, InjectedFault, Journal
from repro_torch.launch.mesh import make_mesh
from repro_torch.serve import DeadlineExceeded, EngineFailure, RMQServer, ServeConfig, ServerClosed
from repro_torch.update.deltas import DeltaBatch, DeltaLog
from torch_parity_util import assert_same_structure, to_np

UPDATABLE = sorted(update.online_names())
MESH8 = make_mesh((8,), ("shard",), devices="cpu")


def _where(name):
    """Where the port runs ``name``: a mesh engine on the 8-shard CPU mesh,
    any other on the CPU."""
    if registry.get(name).needs_mesh:
        return {"mesh": MESH8, "axis_names": ("shard",)}
    return {"device": "cpu"}


def _state(d):
    return d.online.store.current.state


def _mutations(n):
    """Point writes, a leftmost-tie flip, a range fill, and an append."""
    return [
        DeltaLog().point(0, -3.0).point(n - 1, -3.0),
        DeltaLog().fill(n // 4, n // 4 + 70, 0.125),
        DeltaLog().append(np.arange(5, dtype=np.float32)),
    ]


def _create(name, x, root, **kw):
    return DurableEngine.create(name, x, root, **_where(name), **kw)


def _restore(root, name="hybrid", **kw):
    return DurableEngine.restore(root, **_where(name), **kw)


# --- fault plan determinism ---------------------------------------------------


def test_fault_plan_exact_invocations():
    plan = FaultPlan(seed=3, specs={"worker_query": FaultSpec(at=(2, 4))})
    fired = []
    for i in range(1, 6):
        try:
            plan.check("worker_query")
        except InjectedFault as e:
            fired.append((i, e.count, e.site, e.kind))
    assert [f[0] for f in fired] == [2, 4]
    assert all(f[0] == f[1] for f in fired)
    assert fired[0][2:] == ("worker_query", "error")


def test_fault_plan_rate_is_seed_deterministic():
    def firings(seed):
        plan = FaultPlan(seed=seed, specs={"patch_apply": FaultSpec(rate=0.3)})
        out = []
        for i in range(1, 101):
            try:
                plan.check("patch_apply")
            except InjectedFault:
                out.append(i)
        return out

    a, b, c = firings(11), firings(11), firings(12)
    assert a == b and a  # same seed -> same schedule, and it does fire
    assert a != c  # different seed -> different schedule


def test_fault_plan_rejects_unknown_site():
    with pytest.raises(ValueError):
        FaultPlan(specs={"nope": FaultSpec(rate=1.0)})


# --- WAL ----------------------------------------------------------------------


def _batch(seq_marker, n_old=8):
    log = DeltaLog().point(0, float(seq_marker))
    return log.coalesce(n_old, np.float32)


def test_journal_roundtrip_and_replay_dedup(tmp_path):
    path = str(tmp_path / "j.wal")
    j = Journal(path)
    j.append(1, _batch(1.0))
    j.append(2, _batch(2.0))
    j.append(2, _batch(2.0))  # duplicate seq (crash between append and ack)
    j.append(3, _batch(3.0))
    j.close()

    j2 = Journal(path)
    replayed = j2.replay(after_seq=0)
    assert [s for s, _ in replayed] == [1, 2, 3]  # deduped, in order
    assert all(isinstance(b, DeltaBatch) for _, b in replayed)
    assert float(replayed[1][1].val[0]) == 2.0
    suffix = j2.replay(after_seq=2)
    assert [s for s, _ in suffix] == [3]
    assert j2.last_seq == 3
    j2.close()


def test_journal_abort_marker_skips_seq(tmp_path):
    path = str(tmp_path / "j.wal")
    j = Journal(path)
    j.append(1, _batch(1.0))
    j.append(2, _batch(2.0))
    j.abort(2)  # the apply of seq 2 failed: replay must skip it
    j.append(3, _batch(3.0))
    j.close()
    j2 = Journal(path)
    assert [s for s, _ in j2.replay(after_seq=0)] == [1, 3]
    assert j2.last_seq == 3
    j2.close()


def test_journal_torn_tail_recovery(tmp_path):
    """A crash mid-append leaves a torn record; scan stops at the last
    complete one and the next append overwrites the garbage."""
    path = str(tmp_path / "j.wal")
    j = Journal(path)
    j.append(1, _batch(1.0))
    j.append(2, _batch(2.0))
    j.close()
    good_records = Journal(path)
    good = good_records.replay(after_seq=0)
    good_records.close()

    full = open(path, "rb").read()
    for cut in (len(full) - 1, len(full) - 7, len(full) - (len(full) // 3)):
        torn = str(tmp_path / f"torn{cut}.wal")
        with open(torn, "wb") as f:
            f.write(full[:cut])
        jt = Journal(torn)
        rec = jt.replay(after_seq=0)
        assert [s for s, _ in rec] == [1], cut  # seq 2 torn -> dropped
        assert np.array_equal(rec[0][1].val, good[0][1].val)
        jt.append(9, _batch(9.0))  # append after recovery truncates the tail
        assert [s for s, _ in jt.replay(after_seq=0)] == [1, 9]
        jt.close()

    # Garbled bytes inside the tail record (bit rot) fail the checksum.
    bad = bytearray(full)
    bad[-3] ^= 0xFF
    garbled = str(tmp_path / "garbled.wal")
    with open(garbled, "wb") as f:
        f.write(bytes(bad))
    jg = Journal(garbled)
    assert [s for s, _ in jg.replay(after_seq=0)] == [1]
    jg.close()


def test_journal_truncate_upto_compacts(tmp_path):
    path = str(tmp_path / "j.wal")
    j = Journal(path)
    for s in (1, 2, 3, 4):
        j.append(s, _batch(float(s)))
    j.truncate_upto(2)
    assert [s for s, _ in j.replay(after_seq=0)] == [3, 4]
    assert j.last_seq == 4
    j.truncate_upto(4)
    assert j.replay(after_seq=0) == []
    assert j.last_seq == 4  # seqs never reused, even once compacted away
    j.close()
    assert os.path.getsize(path) == 0


def test_journal_injected_append_fault_keeps_journal_clean(tmp_path):
    """An injected (non-crash) append failure must roll the file back to the
    previous record boundary — no torn bytes for later appends to trip on."""
    plan = FaultPlan(seed=0, specs={"journal_append": FaultSpec(at=(2,))})
    path = str(tmp_path / "j.wal")
    j = Journal(path, fault=plan.check)
    j.append(1, _batch(1.0))
    size1 = os.path.getsize(path)
    with pytest.raises(InjectedFault):
        j.append(2, _batch(2.0))
    assert os.path.getsize(path) == size1
    j.append(3, _batch(3.0))
    assert [s for s, _ in j.replay(after_seq=0)] == [1, 3]
    j.close()


def test_delta_batch_bytes_roundtrip():
    log = DeltaLog().point(3, -1.5).fill(10, 20, 0.25).append(np.arange(7, dtype=np.float32))
    batch = log.coalesce(64, np.float32)
    back = DeltaBatch.from_bytes(batch.to_bytes())
    assert np.array_equal(back.idx, batch.idx)
    assert np.array_equal(back.val, batch.val)
    assert np.array_equal(back.tail, batch.tail)
    assert (back.n_old, back.n_new) == (batch.n_old, batch.n_new)
    # The journal's payload is the reference's, byte for byte.
    jlog = JaxDeltaLog().point(3, -1.5).fill(10, 20, 0.25).append(np.arange(7, dtype=np.float32))
    assert batch.to_bytes() == jlog.coalesce(64, np.float32).to_bytes()


# --- checkpoint + restore, every single-host updatable engine -----------------


@pytest.mark.parametrize("name", UPDATABLE)
def test_durable_restore_bit_identical(name, tmp_path):
    """Restore = checkpoint + journal suffix, bit-identical to the live
    engine, with version-id continuity — for every updatable engine."""
    rng = np.random.default_rng(5)
    n = 1536
    x = rng.integers(0, 5, n).astype(np.float32)  # small alphabet: real ties
    root = str(tmp_path / name)
    d = _create(name, x, root)
    xm = x.copy()
    for i, log in enumerate(_mutations(n)):
        d.apply(log)
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        if i == 0:
            d.checkpoint()  # restore crosses a checkpoint + a journal suffix

    r = _restore(root, name)
    assert r.current_vid == d.current_vid
    assert r.n == d.n == xm.shape[0]
    assert r.replayed == 2  # the two post-checkpoint batches
    assert_same_structure(_state(d), _state(r))

    # Replay idempotence: restoring the same root again converges.
    r2 = _restore(root, name)
    assert r2.current_vid == r.current_vid and r2.seq == r.seq
    assert_same_structure(_state(r), _state(r2))

    # And the restored engine answers oracle-correct for its version.
    l = rng.integers(0, xm.shape[0], 128)
    rr = rng.integers(0, xm.shape[0], 128)
    l, rr = np.minimum(l, rr), np.maximum(l, rr)
    ver = r.pin()
    idx, val = r.query(ver.state, l, rr)
    r.release(ver.vid)
    gold = ref.rmq_ref(xm, l, rr)
    assert np.array_equal(to_np(idx), gold), name
    assert np.array_equal(to_np(val), xm[gold]), name
    d.close(), r.close(), r2.close()


def test_durable_restore_survives_torn_journal_tail(tmp_path):
    """Crash mid-journal-append: the torn record's update was never
    acknowledged, so restore lands exactly on the last acked state."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal(512).astype(np.float32)
    root = str(tmp_path / "torn")
    d = _create("hybrid", x, root)
    d.apply(DeltaLog().point(5, -9.0))
    vid_acked = d.current_vid
    d.close()

    # A crash-kind journal fault leaves torn bytes mid-record on disk.
    plan = FaultPlan(seed=0, specs={"journal_append": FaultSpec(at=(1,), kind="crash")})
    base = _restore(root)
    base_online = base.online
    base.close()
    d2 = DurableEngine(base_online, root, fault=plan.check)
    with pytest.raises(InjectedFault):
        d2.apply(DeltaLog().point(6, -9.0))
    d2.close()

    r = _restore(root)
    assert r.current_vid == vid_acked  # torn (unacked) update is gone
    assert r.replayed == 1
    xm = x.copy()
    xm[5] = -9.0
    assert np.isclose(np.asarray(r.online.store.current.x_host)[5], -9.0)
    assert np.array_equal(np.asarray(r.online.store.current.x_host), xm)
    r.close()


def test_failed_checkpoint_leaves_journal_authoritative(tmp_path):
    """An injected checkpoint_write failure leaves a torn temp dir that
    latest_step ignores; restore replays from the previous checkpoint."""
    plan = FaultPlan(seed=0, specs={"checkpoint_write": FaultSpec(at=(2,))})
    rng = np.random.default_rng(7)
    x = rng.standard_normal(512).astype(np.float32)
    root = str(tmp_path / "ck")
    d = _create("sparse_table", x, root, fault=plan)
    d.apply(DeltaLog().point(1, -1.0))
    with pytest.raises(InjectedFault):
        d.checkpoint()  # invocation 2: dies after leaf writes
    assert ckpt_mod.latest_step(d.ckpt_dir) == 0  # only the base checkpoint
    assert os.path.getsize(os.path.join(root, "journal.wal")) > 0  # uncompacted
    d.apply(DeltaLog().point(2, -2.0))
    r = _restore(root)
    assert r.replayed == 2 and r.current_vid == d.current_vid
    assert_same_structure(_state(d), _state(r))
    d.close(), r.close()


def test_poisoned_engine_recovers_via_replay(tmp_path):
    """Mid-patch failure -> EnginePoisoned (cause + seq); recover() replays
    the journal (aborted seq skipped) and clears the poison."""
    plan = FaultPlan(seed=0, specs={"patch_apply": FaultSpec(at=(2,))})
    rng = np.random.default_rng(8)
    x = rng.standard_normal(1024).astype(np.float32)
    root = str(tmp_path / "poison")
    d = _create("hybrid", x, root, fault=plan)
    d.apply(DeltaLog().point(3, -5.0))
    with pytest.raises(InjectedFault):
        d.apply(DeltaLog().point(4, -6.0))  # invocation 2 of patch_apply
    assert d.poisoned
    with pytest.raises(update.EnginePoisoned) as ei:
        d.apply(DeltaLog().point(5, -7.0))
    assert ei.value.seq == 2  # the journaled seq that failed
    assert isinstance(ei.value.cause, InjectedFault)
    assert "fail-stopped" in str(ei.value)
    assert "applying journaled update seq 2" in str(ei.value)
    with pytest.raises(update.EnginePoisoned) as es:
        d.checkpoint()  # a poisoned engine's mirrors never become the base
    assert es.value.seq == 2

    replayed = d.recover()
    assert not d.poisoned
    assert replayed == 1  # seq 1 replays; aborted seq 2 is skipped
    assert d.current_vid == 1
    res = d.apply(DeltaLog().point(4, -6.0))  # resubmit works post-recovery
    assert res.version == 2
    xm = x.copy()
    xm[3], xm[4] = -5.0, -6.0
    assert np.array_equal(np.asarray(d.online.store.current.x_host), xm)
    d.close()


def test_engine_poisoned_message_matches_reference():
    cause = RuntimeError("device lost")
    for seq in (7, None):
        port = update.EnginePoisoned("hybrid", seq, cause)
        jax_err = jax_update.EnginePoisoned("hybrid", seq, cause)
        assert str(port) == str(jax_err)
        assert (port.engine, port.seq, port.cause) == ("hybrid", seq, cause)


@pytest.mark.parametrize("name,kw", [("distributed", {}), ("sharded_hybrid", {"mode": "shard_structure"})])
def test_sharded_durable_restore_on_8_device_mesh(name, kw, tmp_path):
    """The reference's 8-device child, in-process on an 8-shard CPU mesh:
    a checkpoint after the first of three logs (a shard-boundary tie, a
    range over three shards, an append), a restore that replays the other
    two and equals the live patched leaves, and answers that equal the
    oracle."""
    axes = ("shard",)
    rng = np.random.default_rng(4)
    n = 4096  # 8 shards x 512 cols
    x = rng.integers(0, 4, n).astype(np.float32)
    root = str(tmp_path / name)
    d = DurableEngine.create(name, x, root, mesh=MESH8, axis_names=axes, **kw)
    xm = x.copy()
    logs = [
        DeltaLog().point(1023, -7.0).point(1024, -7.0),  # shard-boundary tie
        DeltaLog().fill(500, 1600, 0.25),  # 3-shard range
        DeltaLog().append(rng.integers(0, 4, 50).astype(np.float32)),
    ]
    for i, log in enumerate(logs):
        d.apply(log)
        xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
        if i == 0:
            d.checkpoint()
    r = DurableEngine.restore(root, mesh=MESH8, axis_names=axes)
    assert r.current_vid == d.current_vid and r.replayed == 2
    assert r.mesh is MESH8 and ckpt_mod.load_snapshot(os.path.join(root, "ckpt"))[0].keys() == {"x"}
    assert_same_structure(_state(d), _state(r))
    l = rng.integers(0, xm.shape[0], 200)
    rr = rng.integers(0, xm.shape[0], 200)
    l, rr = np.minimum(l, rr), np.maximum(l, rr)
    ver = r.pin()
    idx, val = r.query(ver.state, l, rr)
    r.release(ver.vid)
    gold = ref.rmq_ref(xm, l, rr)
    np.testing.assert_array_equal(to_np(idx), gold)
    np.testing.assert_array_equal(to_np(val), xm[gold])
    assert r.recover() == 2 and r.mesh is MESH8  # in place, on the same mesh
    d.close(), r.close()


# --- supervised serving -------------------------------------------------------


def _serve_x(n=2048, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5, n).astype(np.float32), rng


def _online(name, x):
    return update.make_online(name, x, device="cpu")


def test_worker_crash_restart_and_retry_nothing_lost():
    """An injected crash kills the worker thread mid-launch; the supervisor
    restarts it and the batch's requests retry — every answer still exact."""
    x, rng = _serve_x()
    plan = FaultPlan(seed=2, specs={"worker_query": FaultSpec(at=(2,), kind="crash")})
    online = _online("hybrid", x)
    cfg = ServeConfig(workers=2, deadline_s=5e-4, max_retries=4, worker_backoff_s=0.005)
    with RMQServer(online=online, fault_plan=plan, config=cfg) as srv:
        futs = []
        for _ in range(12):
            l = rng.integers(0, x.shape[0], 3).astype(np.int32)
            r = np.minimum(x.shape[0] - 1, l + rng.integers(0, 400, 3)).astype(np.int32)
            futs.append((l, r, srv.submit(l, r)))
            time.sleep(0.002)
        for l, r, f in futs:
            res = f.result(timeout=60)
            gold = ref.rmq_ref(x, l, r)
            assert np.array_equal(res.idx, gold)
        st = srv.stats()
    assert st.worker_restarts >= 1
    assert st.retried_requests >= 1
    assert st.failed_requests == 0


def test_engine_failure_is_typed_and_carries_cause():
    x, _ = _serve_x()
    plan = FaultPlan(seed=2, specs={"worker_query": FaultSpec(at=(1,))})
    online = _online("hybrid", x)
    cfg = ServeConfig(workers=1, deadline_s=1e-4)  # max_retries=0: fail fast
    with RMQServer(online=online, fault_plan=plan, config=cfg) as srv:
        f = srv.submit(np.zeros(1, np.int32), np.zeros(1, np.int32))
        with pytest.raises(EngineFailure) as ei:
            f.result(timeout=60)
        assert isinstance(ei.value.cause, InjectedFault)
        assert ei.value.retryable
        st = srv.stats()
    assert st.failed_requests == 1


def test_breaker_trips_to_degraded_then_recloses():
    """K consecutive failures open the breaker; launches route to the
    plain fallback (correct, counted); a health probe recloses it and the
    primary serves again."""
    x, rng = _serve_x()
    # Invocations 1..3 fail (the trip + the first health probe); after that
    # the primary is healthy and the next probe recloses the breaker.
    plan = FaultPlan(seed=2, specs={"worker_query": FaultSpec(at=(1, 2, 3))})
    online = _online("hybrid", x)
    cfg = ServeConfig(
        workers=1, deadline_s=5e-4, max_retries=6, breaker_threshold=2, breaker_cooldown_s=0.005
    )
    with RMQServer(online=online, fault_plan=plan, config=cfg) as srv:

        def wave(count, gap):
            futs = []
            for _ in range(count):
                l = rng.integers(0, x.shape[0], 2).astype(np.int32)
                r = np.minimum(x.shape[0] - 1, l + rng.integers(0, 300, 2)).astype(np.int32)
                futs.append((l, r, srv.submit(l, r)))
                time.sleep(gap)
            for l, r, f in futs:
                res = f.result(timeout=60)
                gold = ref.rmq_ref(x, l, r)
                assert np.array_equal(res.idx, gold)
                assert np.array_equal(res.val, x[gold])

        wave(10, 0.003)  # trips the breaker, mostly degraded launches
        # Spaced past the cooldown: each launch gets a probe opportunity, so
        # the breaker recloses within the first couple of requests.
        wave(12, 0.02)
        st = srv.stats()
    assert st.breaker_trips >= 1
    assert st.degraded_launches >= 1
    assert st.failed_requests == 0
    # The breaker reclosed: the tail of the traffic ran on the primary.
    assert st.degraded_launches < st.n_batches


def test_request_timeout_expires_stale_requests():
    """A request older than request_timeout_s fails with DeadlineExceeded at
    flush instead of occupying a launch."""
    done = []

    def slow(l, r):
        done.append(l.size)
        time.sleep(0.15)
        return np.zeros(l.size, np.int32), np.zeros(l.size, np.float32)

    cfg = ServeConfig(workers=1, deadline_s=0.3, request_timeout_s=0.05, n=16)
    with RMQServer(query_fn=slow, config=cfg) as srv:
        f = srv.submit(np.zeros(1, np.int32), np.zeros(1, np.int32))
        # Sits in the batcher past its deadline (flush deadline is 0.3s).
        with pytest.raises(DeadlineExceeded):
            f.result(timeout=60)
        st = srv.stats()
    assert st.expired_requests == 1
    assert done == []  # never launched


def test_close_fails_pending_futures():
    """close(timeout=) must not leave a blocked client: leftover futures
    fail with ServerClosed."""

    def wedge(l, r):
        time.sleep(30)
        return np.zeros(l.size, np.int32), np.zeros(l.size, np.float32)

    srv = RMQServer(query_fn=wedge, config=ServeConfig(workers=1, deadline_s=1e-4)).start()
    f = srv.submit(np.zeros(1, np.int32), np.zeros(1, np.int32))
    time.sleep(0.05)
    srv.close(timeout=0.2)
    with pytest.raises(ServerClosed):
        f.result(timeout=1)


def test_close_fails_pending_update_futures():
    """An update still queued behind a wedged one fails with ServerClosed."""
    x, _ = _serve_x(512)

    class SlowOnline:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, k):
            return getattr(self._inner, k)

        def apply(self, deltas, **kw):
            time.sleep(30)
            return self._inner.apply(deltas, **kw)

    online = SlowOnline(_online("sparse_table", x))
    srv = RMQServer(online=online, config=ServeConfig(workers=1, deadline_s=1e-4)).start()
    srv.submit_update(DeltaLog().point(0, 1.0))
    f2 = srv.submit_update(DeltaLog().point(1, 1.0))
    time.sleep(0.05)
    srv.close(timeout=0.2)
    with pytest.raises(ServerClosed):
        f2.result(timeout=1)


def test_server_restore_kwarg_serves_restored_engine(tmp_path):
    x, rng = _serve_x(1024)
    root = str(tmp_path / "srvroot")
    d = _create("hybrid", x, root)
    d.apply(DeltaLog().point(10, -4.0))
    d.close()
    xm = x.copy()
    xm[10] = -4.0
    with pytest.raises(ValueError, match="exactly one"):
        RMQServer(online=d, restore=root)
    with RMQServer(restore=root, device="cpu", config=ServeConfig(workers=1, deadline_s=5e-4)) as srv:
        assert isinstance(srv.online, DurableEngine)
        assert srv.online.current_vid == 1
        l = rng.integers(0, 1024, 16).astype(np.int32)
        r = np.minimum(1023, l + rng.integers(0, 200, 16)).astype(np.int32)
        res = srv.submit(l, r).result(timeout=60)
        gold = ref.rmq_ref(xm, l, r)
        assert np.array_equal(res.idx, gold)
        # A durable engine takes updates through the server too, journaled.
        ures = srv.submit_update(DeltaLog().point(11, -5.0)).result(timeout=60)
        assert ures.version == 2 and srv.online.seq == 2
        srv.online.close()


# --- the durable root across packages -----------------------------------------

CROSS_N = 1536
PORT = SimpleNamespace(
    Durable=DurableEngine, DeltaLog=DeltaLog, FaultPlan=FaultPlan, FaultSpec=FaultSpec,
    InjectedFault=InjectedFault, kw=_where, array=lambda a: a,
)
REFERENCE = SimpleNamespace(
    Durable=jax_fault.DurableEngine, DeltaLog=JaxDeltaLog, FaultPlan=jax_fault.FaultPlan,
    FaultSpec=jax_fault.FaultSpec, InjectedFault=jax_fault.InjectedFault, kw=lambda name: {},
    array=jnp.asarray,
)


def _timeline(pkg, name, x, root):
    """One durable timeline in either package: two updates, a checkpoint,
    an update whose apply fails (abort marker) and is recovered and
    resubmitted, and an append; then a crash (the journal closed). Returns
    the live engine's (current_vid, seq)."""
    plan = pkg.FaultPlan(seed=0, specs={"patch_apply": pkg.FaultSpec(at=(3,))})
    d = pkg.Durable.create(name, pkg.array(x), root, fault=plan, **pkg.kw(name))
    n = x.shape[0]
    d.apply(pkg.DeltaLog().point(0, -3.0).point(n - 1, -3.0))
    d.apply(pkg.DeltaLog().fill(n // 4, n // 4 + 70, 0.125))
    d.checkpoint()
    with pytest.raises(pkg.InjectedFault):
        d.apply(pkg.DeltaLog().point(7, -8.0))  # seq 3: abort-marked
    assert d.recover() == 0
    d.apply(pkg.DeltaLog().point(7, -8.0))  # seq 4
    d.apply(pkg.DeltaLog().append(np.arange(5, dtype=np.float32)))  # seq 5
    live = (d.current_vid, d.seq)
    d.close()
    return live


@pytest.fixture(scope="module", params=UPDATABLE)
def roots(request, tmp_path_factory):
    name = request.param
    x = np.random.default_rng(11).integers(0, 5, CROSS_N).astype(np.float32)
    base = tmp_path_factory.mktemp(f"cross_{name}")
    out = SimpleNamespace(name=name, ref=str(base / "ref"), port=str(base / "port"))
    out.live = _timeline(REFERENCE, name, x, out.ref)
    assert _timeline(PORT, name, x, out.port) == out.live == (4, 5)
    xm = x.copy()
    xm[0] = xm[-1] = -3.0
    xm[CROSS_N // 4 : CROSS_N // 4 + 71] = 0.125
    xm[7] = -8.0
    out.xm = np.concatenate([xm, np.arange(5, dtype=np.float32)])
    return out


def _assert_same_restore(root, roots):
    """The same root restored by each package: the same version id, seq,
    replay count and array, and the same leaves. A mesh engine's leaves
    depend on its mesh: the port's 8-shard restore equals its own build on
    that mesh, and the root restored on the CPU's one-shard mesh equals the
    reference's."""
    jr, pr = REFERENCE.Durable.restore(root), _restore(root, roots.name)
    assert (jr.current_vid, jr.seq, jr.replayed) == (pr.current_vid, pr.seq, pr.replayed)
    assert (pr.current_vid, pr.seq, pr.replayed) == (*roots.live, 2)  # seq 3 aborted
    np.testing.assert_array_equal(np.asarray(pr.store.current.x_host), roots.xm)
    if registry.get(roots.name).needs_mesh:
        build_kw = pr.online.snapshot()[1]["build_kw"]
        fresh = update.make_online(roots.name, roots.xm, **_where(roots.name), **build_kw)
        assert_same_structure(fresh.store.current.state, _state(pr))
        one = DurableEngine.restore(root, device="cpu")
        assert_same_structure(_state(jr), _state(one))
        one.close()
    else:
        assert_same_structure(_state(jr), _state(pr))
    jr.close(), pr.close()


def test_reference_root_restores_in_the_port(roots):
    _assert_same_restore(roots.ref, roots)


def test_port_root_restores_in_the_reference(roots):
    _assert_same_restore(roots.port, roots)


def test_durable_roots_are_byte_identical(roots):
    """Journal, manifests and leaf files of the same timeline, per package."""
    a, b = Path(roots.ref), Path(roots.port)
    assert (a / "journal.wal").read_bytes() == (b / "journal.wal").read_bytes()
    steps = sorted(p.name for p in (a / "ckpt").iterdir())
    assert steps == sorted(p.name for p in (b / "ckpt").iterdir()) == ["step_00000000", "step_00000002"]
    for step in steps:
        files = sorted(p.name for p in (a / "ckpt" / step).iterdir())
        assert files == sorted(p.name for p in (b / "ckpt" / step).iterdir())
        assert "manifest.json" in files
        for f in files:
            assert (a / "ckpt" / step / f).read_bytes() == (b / "ckpt" / step / f).read_bytes(), (step, f)
