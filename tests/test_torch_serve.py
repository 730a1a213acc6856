"""repro_torch serving: batcher, RMQServer and the serve CLI, on the CPU.

The single-device subset of ``tests/test_serve.py`` and ``tests/test_obs.py``
against the port, plus ``launch.serve.main`` oneshot and async with
``--device cpu`` at small n. Every served answer is checked against the
numpy oracle (exact) and, where the reference serves the same requests,
against the reference's answers.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ref
from repro.core import registry as jax_registry
from repro_torch.core import build as build_mod
from repro_torch.core import hybrid, registry
from repro_torch.fault import FaultPlan, FaultSpec
from repro_torch.launch import serve
from repro_torch.obs import Tracer, verify_request_chains
from repro_torch.serve import (
    EngineFailure,
    RMQServer,
    ServeConfig,
    ServerClosed,
    ServerOverloaded,
    batcher,
)
from repro_torch.serve.workload import make_queries


def _oracle_engine(x):
    """A (l, r) -> (idx, val) engine that is literally the oracle, as tensors."""

    def qfn(l, r):
        idx = ref.rmq_ref(x, l, r).astype(np.int32)
        return torch.from_numpy(idx), torch.from_numpy(x[idx])

    return qfn


def _bounded(rng, n, b):
    a = rng.integers(0, n, b)
    c = rng.integers(0, n, b)
    return np.minimum(a, c).astype(np.int32), np.maximum(a, c).astype(np.int32)


def test_scatter_back_brings_tensors_to_the_host():
    mb = batcher.coalesce([np.array([1, 2]), np.array([3])], [np.array([4, 5]), np.array([6])])
    assert mb.padded_size == 4 and mb.n_queries == 3
    parts = batcher.scatter_back(mb, torch.arange(4, dtype=torch.int32), torch.arange(4.0))
    assert [p[0].tolist() for p in parts] == [[0, 1], [2]]
    assert all(isinstance(i, np.ndarray) and i.dtype == np.int32 for i, _ in parts)


def test_served_hybrid_matches_reference_under_mixed_regimes():
    """Three clients, three range regimes, through the port's registry hybrid
    (and its kernel path): every answer equals the oracle and the reference
    engine's answer to the same request."""
    rng = np.random.default_rng(4)
    n = 4096
    x = rng.integers(0, 9, n).astype(np.float32)  # dense ties
    jeng = jax_registry.get("hybrid")
    jstate = jeng.build(jnp.asarray(x))
    for use_kernels in (False, True):
        state = hybrid.build(x, 128, use_kernels=use_kernels, device="cpu")
        qfn = lambda l, r: hybrid.query(state, l, r)
        results, lock = [], threading.Lock()

        def client(c, dist):
            crng = np.random.default_rng(100 + c)
            for _ in range(5):
                l, r = make_queries(crng, n, 1 + crng.integers(1, 12), dist)
                with lock:
                    results.append((l, r, srv.submit(l, r)))

        with RMQServer(qfn, ServeConfig(deadline_s=0.02, max_batch=256, n=n)) as srv:
            threads = [threading.Thread(target=client, args=(c, d)) for c, d in enumerate(("small", "medium", "large"))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            done = [(l, r, f.result(timeout=120)) for l, r, f in results]
        assert len(done) == 15
        for l, r, res in done:
            gold = ref.rmq_ref(x, l, r)
            assert res.idx.dtype == np.int32 and res.val.dtype == np.float32
            np.testing.assert_array_equal(res.idx, gold)
            np.testing.assert_array_equal(res.val, x[gold])
            ji, jv = jeng.query(jstate, jnp.asarray(l), jnp.asarray(r))
            np.testing.assert_array_equal(res.idx, np.asarray(ji))
            np.testing.assert_array_equal(res.val, np.asarray(jv))
        st = srv.stats()
        assert st.n_batches < 15 and st.short_queries + st.long_queries == st.served_queries


def test_regime_split_counts_in_stats():
    rng = np.random.default_rng(7)
    n = 2048
    x = rng.random(n, dtype=np.float32)
    s = hybrid.build(x, 128, use_kernels=False, threshold=16, device="cpu")
    qfn = lambda l, r: hybrid.query(s, l, r)
    l1 = np.array([0, 5, 9, 100, 200, 300, 400, 500], np.int32)
    r1 = np.array([3, 20, 9, 115, 210, 1300, 1400, 1500], np.int32)
    l2 = np.array([1, 2, 3], np.int32)
    r2 = np.array([4, 5, 6], np.int32)
    with RMQServer(qfn, ServeConfig(deadline_s=0.0, max_batch=64, n=n)) as srv:
        srv.submit(l1, r1).result(timeout=60)
        srv.submit(l2, r2).result(timeout=60)
    st = srv.stats()
    assert st.regime_splits == ((5, 3), (3, 0))
    assert st.mixed_batches == 1
    assert "regime split 8 short / 3 long" in st.summary()


def test_microbatcher_coalesces_and_pads():
    rng = np.random.default_rng(1)
    n = 256
    x = rng.random(n).astype(np.float32)
    with RMQServer(_oracle_engine(x), ServeConfig(deadline_s=0.5, max_batch=1024, n=n)) as srv:
        futs = [(l, r, srv.submit(l, r)) for l, r in (_bounded(rng, n, 4 + c) for c in range(3))]
        results = [(l, r, f.result(timeout=30)) for l, r, f in futs]
    st = srv.stats()
    assert st.n_batches == 1 and st.padded_sizes == (16,)
    for l, r, res in results:
        np.testing.assert_array_equal(res.idx, ref.rmq_ref(x, l, r))


def test_warmup_bounds_from_plan_run_each_regime():
    n = 512
    plan = registry.plan_for_serving("hybrid", n, "cpu", threshold=32)
    x = np.random.default_rng(0).random(n, dtype=np.float32)
    calls = []

    def qfn(l, r):
        calls.append((l.size, int(r[0] - l[0] + 1)))
        return _oracle_engine(x)(l, r)

    RMQServer(qfn, ServeConfig(max_batch=8, n=n), warmup_bounds=build_mod.warmup_bounds(plan)).warmup()
    assert calls == [(s, ln) for s in (1, 2, 4, 8) for ln in (32, n)]


def test_admission_validation_and_close():
    x = np.ones(16, np.float32)
    release = threading.Event()

    def slow(l, r):
        release.wait(30)
        return _oracle_engine(x)(l, r)

    with RMQServer(slow, ServeConfig(deadline_s=0.0, max_batch=8, max_pending=2, n=16)) as srv:
        one = np.zeros(1, np.int32)
        f1, f2 = srv.submit(one, one), srv.submit(one, one)
        with pytest.raises(ServerOverloaded):
            srv.submit(one, one)
        release.set()
        f1.result(timeout=30), f2.result(timeout=30)
        with pytest.raises(ValueError):  # r >= n
            srv.submit(one, np.array([16], np.int32))
        with pytest.raises(TypeError):
            srv.submit(np.array([0.5]), np.array([1.5]))
        empty = srv.submit(np.zeros(0, np.int64), np.zeros(0, np.int64)).result(timeout=5)
        assert empty.idx.shape == (0,)
    assert srv.stats().rejected_requests == 1
    with pytest.raises(ServerClosed):
        srv.submit(np.zeros(1, np.int32), np.zeros(1, np.int32))


def test_crash_restart_retry_and_breaker_fallback():
    """An injected worker crash is restarted by the supervisor and its batch
    retried; a persistently failing primary trips the breaker onto the
    explicit fallback, whose answers are still exact."""
    rng = np.random.default_rng(9)
    n = 300
    x = rng.random(n, dtype=np.float32)
    s = hybrid.build(x, 128, use_kernels=True, device="cpu")
    qfn = lambda l, r: hybrid.query(s, l, r)
    plan = FaultPlan(seed=1, specs={"worker_query": FaultSpec(at=(1,), kind="crash")})
    with RMQServer(qfn, ServeConfig(deadline_s=0.0, n=n, max_retries=2), fault_plan=plan) as srv:
        l, r = _bounded(rng, n, 7)
        res = srv.submit(l, r).result(timeout=30)
        np.testing.assert_array_equal(res.idx, ref.rmq_ref(x, l, r))
    st = srv.stats()
    assert st.worker_restarts == 1 and st.retried_requests == 1

    def broken(l, r):
        raise RuntimeError("primary down")

    cfg = ServeConfig(deadline_s=0.0, n=n, breaker_threshold=1, breaker_cooldown_s=60.0)
    with RMQServer(broken, cfg, fallback=qfn) as srv:
        l, r = _bounded(rng, n, 5)
        with pytest.raises(EngineFailure):
            srv.submit(l, r).result(timeout=30)
        res = srv.submit(l, r).result(timeout=30)
        np.testing.assert_array_equal(res.idx, ref.rmq_ref(x, l, r))
    st = srv.stats()
    assert st.breaker_trips == 1 and st.degraded_launches == 1
    with pytest.raises(ValueError, match="fallback"):
        RMQServer(broken, cfg)


def test_trace_chains_and_metrics_reconcile():
    rng = np.random.default_rng(3)
    n = 512
    x = rng.random(n, dtype=np.float32)
    tracer = Tracer(enabled=True)
    with RMQServer(_oracle_engine(x), ServeConfig(deadline_s=0.005, n=n), tracer=tracer) as srv:
        futs = [srv.submit(*_bounded(rng, n, 5)) for _ in range(12)]
        for f in futs:
            f.result(timeout=60)
    complete, problems = verify_request_chains(tracer.spans())
    assert (complete, problems) == (12, [])
    st = srv.stats()
    reg = srv.metrics
    assert reg.counter_total("serve_requests_total", outcome="served") == st.served_requests == 12
    assert reg.counter_total("serve_batches_total") == st.n_batches
    assert reg.histogram("serve_total_s").percentile(99) == pytest.approx(st.p99_total_s)


def test_adaptive_deadline_moves_and_is_recorded():
    rng = np.random.default_rng(11)
    n = 64
    x = rng.random(n).astype(np.float32)
    cfg = ServeConfig(deadline_s=0.01, max_batch=8, n=n, adaptive_deadline=True)
    with RMQServer(_oracle_engine(x), cfg) as srv:
        for _ in range(3):  # size-triggered flushes: the deadline halves to its floor
            srv.submit(*_bounded(rng, n, 8)).result(timeout=30)
        time.sleep(0.05)
        srv.submit(*_bounded(rng, n, 1)).result(timeout=30)  # deadline flush, near empty: grows
    traj = srv.stats().deadline_trajectory
    assert traj[:3] == (0.005, 0.0025, 0.00125) and traj[3] == pytest.approx(0.001875)


@pytest.mark.parametrize("engine", ["hybrid", "fused128", "sparse_table", "lane", "lca", "packed_hybrid"])
def test_serve_cli_oneshot_on_cpu(engine, capsys):
    serve.main(["--device", "cpu", "--engine", engine, "--n", "4096", "--batch", "256", "--batches", "2"])
    out = capsys.readouterr().out
    assert f"[{engine}] build" in out and "verify[64] OK" in out


@pytest.mark.parametrize("dist", ["small", "medium"])
def test_serve_cli_async_on_cpu(dist, capsys, tmp_path):
    trace = tmp_path / "trace.json"
    serve.main(
        [
            "--device", "cpu", "--mode", "async", "--engine", "hybrid", "--n", "4096",
            "--dist", dist, "--clients", "2", "--requests", "6", "--req-batch", "16",
            "--max-batch", "64", "--trace", str(trace),
        ]
    )
    out = capsys.readouterr().out
    assert "verify: 12/12 requests bit-identical to the oracle" in out
    assert "(12 complete request chains" in out and trace.exists()


@pytest.mark.parametrize(
    "packed,layout", [("auto", "packed64"), ("packed64", "packed64"), ("quantized", "quantized")]
)
def test_serve_cli_packed_on_cpu(packed, layout, capsys):
    """--packed builds the packed structures; the build line names the layout
    the data resolved to (float data: auto -> packed64, as in the reference)."""
    serve.main(
        ["--device", "cpu", "--engine", "packed_hybrid", "--packed", packed, "--n", "4096",
         "--batch", "256", "--batches", "2"]
    )
    out = capsys.readouterr().out
    assert f"layout {layout}" in out and "verify[64] OK" in out


def test_serve_cli_packed_async_and_flag_validation(capsys):
    serve.main(
        [
            "--device", "cpu", "--mode", "async", "--engine", "packed_hybrid", "--packed",
            "quantized", "--n", "4096", "--clients", "2", "--requests", "4", "--req-batch", "16",
            "--max-batch", "64",
        ]
    )
    out = capsys.readouterr().out
    assert "layout quantized" in out and "verify: 8/8 requests bit-identical to the oracle" in out
    with pytest.raises(SystemExit):  # lane declares no 'packed' build kwarg
        serve.main(["--device", "cpu", "--engine", "lane", "--packed", "--n", "1024"])
    assert "--packed requires an engine with a 'packed' build kwarg" in capsys.readouterr().err


def test_serve_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--n", "1024"])
