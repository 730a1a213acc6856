"""repro_torch's online server: updates interleaved with queries, on the CPU.

The serving tests of ``tests/test_update.py`` on the port (the barrier
between updates and queries, ``submit_update`` without an online engine,
bounds checked against the current length), the breaker of an online
server answering through ``fault.DegradedFallback`` against each launch's
pinned version, and the serve CLI's ``--mutate``: every request equal to the
oracle of its pinned version, and the flag refused where the reference
refuses it. With ``--restore DIR`` a second run resumes the first's durable
root (its versions continue) and ``--chaos`` runs the seeded soak to an
``[OK]`` report. Tolerance: exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch import update
from repro_torch.core import ref
from repro_torch.fault import DegradedFallback, fallback
from repro_torch.launch import serve
from repro_torch.serve import EngineFailure, RMQServer, ServeConfig

ROOT = Path(__file__).resolve().parents[1]


def _online(name, x, **kw):
    return update.make_online(name, x, device="cpu", **kw)


def test_server_interleaves_updates_with_queries():
    """submit_update is a batcher barrier: pre-update requests answer against
    the pre-update version, post-update requests see the published one."""
    x = np.ones(128, np.float32)
    online = _online("hybrid", x, threshold=16)
    with RMQServer(online=online, config=ServeConfig(deadline_s=0.2, max_batch=64)) as srv:
        one = np.array([0], np.int32)
        last = np.array([127], np.int32)
        f1 = srv.submit(one, last)  # coalescing: pending when the update lands
        uf = srv.submit_update(update.DeltaLog().point(64, -3.0))
        ures = uf.result(timeout=30)
        f2 = srv.submit(one, last)
        r1 = f1.result(timeout=30)
        r2 = f2.result(timeout=30)
    assert ures.version == 1 and ures.patched and ures.n_writes == 1
    assert r1.version == 0 and r1.idx[0] == 0  # pre-update snapshot
    assert r2.version == 1 and r2.idx[0] == 64  # sees the write
    st = srv.stats()
    assert st.applied_updates == 1
    assert st.p99_update_s >= st.p50_update_s > 0
    assert "1 updates" in st.summary()


def test_submit_update_requires_online_engine():
    srv = RMQServer(lambda l, r: (l, l.astype(np.float32)), ServeConfig(n=8)).start()
    try:
        with pytest.raises(ValueError):
            srv.submit_update(update.DeltaLog().point(0, 1.0))
    finally:
        srv.close()
    with pytest.raises(ValueError, match="exactly one"):
        RMQServer(lambda l, r: (l, l), online=_online("sparse_table", np.arange(8.0, dtype=np.float32)))


def test_online_server_validates_against_current_length():
    online = _online("sparse_table", np.arange(16.0, dtype=np.float32))
    with RMQServer(online=online, config=ServeConfig(deadline_s=0.0)) as srv:
        with pytest.raises(ValueError):
            srv.submit(np.array([0], np.int32), np.array([16], np.int32))
        with pytest.raises(ValueError, match="empty"):
            srv.submit_update(update.DeltaLog())
        srv.submit_update(update.DeltaLog().append(np.arange(4.0))).result(timeout=30)
        res = srv.submit(np.array([0], np.int32), np.array([19], np.int32)).result(timeout=30)
        assert res.idx[0] == 0


def test_failed_update_keeps_serving_and_fails_its_future():
    """A malformed batch fails its own future with the engine untouched;
    queries and later updates go on."""
    online = _online("block128", np.arange(300.0, dtype=np.float32))
    with RMQServer(online=online, config=ServeConfig(deadline_s=0.0, n=300)) as srv:
        stale = update.DeltaLog().point(1, -1.0).coalesce(299)  # wrong length
        with pytest.raises(ValueError):
            srv.submit_update(stale).result(timeout=30)
        res = srv.submit_update(update.DeltaLog().point(7, -2.0)).result(timeout=30)
        got = srv.submit(np.array([0], np.int32), np.array([299], np.int32)).result(timeout=30)
    assert res.version == 1 and got.version == 1 and got.idx[0] == 7
    assert srv.stats().applied_updates == 1


def test_online_breaker_answers_through_the_degraded_fallback():
    """A primary that keeps failing trips the breaker of an online server:
    later launches are answered by ``DegradedFallback``'s sparse table over
    the pinned version's host array, so an update published before the
    launch is seen, and the answers are the oracle's of that version."""
    rng = np.random.default_rng(4)
    n = 500
    x = rng.integers(0, 9, n).astype(np.float32)
    online = _online("hybrid", x, threshold=32)

    def primary_down(site):
        raise RuntimeError("primary down")

    cfg = ServeConfig(deadline_s=0.0, breaker_threshold=1, breaker_cooldown_s=60.0)
    l = np.array([0, 3, 100, 250], np.int32)
    r = np.array([n - 1, 40, 101, 499], np.int32)
    with RMQServer(online=online, config=cfg, fault_plan=primary_down) as srv:
        with pytest.raises(EngineFailure):
            srv.submit(l, r).result(timeout=30)
        res0 = srv.submit(l, r).result(timeout=30)
        log = update.DeltaLog().point(250, -5.0).append(np.full(10, -9.0, np.float32))
        srv.submit_update(log).result(timeout=30)
        res1 = srv.submit(l, r + 10).result(timeout=30)
    xm = log.coalesce(n, np.float32).apply_numpy(x)
    assert res0.version == 0 and res1.version == 1
    np.testing.assert_array_equal(res0.idx, ref.rmq_ref(x, l, r))
    np.testing.assert_array_equal(res1.idx, ref.rmq_ref(xm, l, r + 10))
    np.testing.assert_array_equal(res1.val, xm[res1.idx])
    st = srv.stats()
    assert st.breaker_trips == 1 and st.degraded_launches == 2 and st.applied_updates == 1
    assert isinstance(srv._degraded, DegradedFallback)


def test_degraded_fallback_caches_versions_and_needs_a_host_array():
    x = np.array([3.0, 1.0, 2.0, 1.0], np.float32)
    fb = DegradedFallback(device="cpu")
    v0 = update.Version(0, None, 4, x)
    idx, val = fb.query(v0, [0, 2], [3, 2])
    assert idx.tolist() == [1, 2] and val.tolist() == [1.0, 2.0]
    v1 = update.Version(1, None, 4, x[::-1].copy())
    assert fb.query(v1, [0], [3])[0].tolist() == [0]
    for vid in range(2, fallback.CACHED_VERSIONS + 1):
        fb.query(update.Version(vid, None, 4, x), [0], [3])
    fb.query(v1, [0], [3])  # a hit moves version 1 to the back of the LRU
    assert list(fb._cache) == [*range(2, fallback.CACHED_VERSIONS + 1), 1]  # version 0 dropped
    with pytest.raises(RuntimeError, match="x_host"):
        fb.query(update.Version(fallback.CACHED_VERSIONS + 1, None, 4, None), [0], [1])


def test_serve_cli_mutate_verifies_every_request_against_its_version():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--mode", "async",
         "--engine", "hybrid", "--mutate", "4", "--n", "4096"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[hybrid] online build" in out.stdout
    assert "mutate: 4 update batches applied (4 patched, 0 rebuilt), n 4096 -> 4128" in out.stdout
    assert "verify: 128/128 requests bit-identical to the oracle of their pinned version" in out.stdout
    assert "served versions (vid: requests):" in out.stdout


@pytest.mark.parametrize(
    "argv,match",
    [
        (["--engine", "hybrid", "--mutate", "2"], "--mutate requires --mode async"),
        (["--engine", "lane", "--mode", "async", "--mutate", "2"], "--mutate requires an updatable engine"),
        (["--engine", "fused128", "--mode", "async", "--mutate", "2"], "--mutate requires an updatable engine"),
    ],
)
def test_serve_cli_mutate_flag_validation(argv, match, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--n", "1024", *argv])
    assert match in capsys.readouterr().err


def test_serve_cli_restore_creates_then_restores(tmp_path, capsys):
    """The first ``--restore`` run creates the durable root, the second
    restores it (checkpoint + 4 journal records) and continues the
    timeline at versions 5-8; both verify every request."""
    root = str(tmp_path / "root")
    argv = ["--device", "cpu", "--mode", "async", "--engine", "hybrid", "--mutate", "4",
            "--restore", root, "--n", "4096"]
    serve.main(argv)
    first = capsys.readouterr().out
    assert "restored from" not in first and "[hybrid] online build" in first
    assert "verify: 128/128 requests bit-identical" in first
    serve.main(argv)
    second = capsys.readouterr().out
    assert f"[hybrid] restored from {root}: version 4, seq 4, n=4128 (4 journal records replayed)" in second
    assert "mutate: 4 update batches applied (4 patched, 0 rebuilt), n 4128 -> 4160" in second
    assert all(f"update v{v}:" in second for v in range(5, 9))
    assert "verify: 128/128 requests bit-identical" in second


def test_serve_cli_chaos_soak_reports_ok(capsys):
    serve.main(["--device", "cpu", "--chaos", "0", "--n", "8192"])
    out = capsys.readouterr().out
    summary = next(line for line in out.splitlines() if line.startswith("["))
    assert summary.startswith("[OK] hybrid seed=0:"), summary
    assert "(1 injected apply failures -> 1 recoveries), 1 failed checkpoints" in summary
    assert "mismatches=0 lost=0" in summary and "identical=True rebuild=True serves=True" in summary


@pytest.mark.parametrize(
    "argv,match",
    [
        (["--engine", "hybrid", "--mode", "async", "--restore", "root"],
         "--restore requires --mutate (durable online serving) or --chaos"),
        (["--engine", "lane", "--chaos", "1"], "--chaos requires an updatable engine"),
        (["--engine", "fused128", "--chaos", "1"], "--chaos requires an updatable engine"),
    ],
)
def test_serve_cli_restore_and_chaos_flag_validation(argv, match, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--n", "1024", *argv])
    assert match in capsys.readouterr().err
