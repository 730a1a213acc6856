"""RMQ serving launcher — thin CLI over the serve subsystem + engine registry.

Two modes:

* ``--mode oneshot`` (default): build once, dispatch pre-formed query
  batches synchronously, verify a sample against the numpy oracle.
* ``--mode async``: concurrent simulated clients submit variable-size
  requests through ``repro_torch.serve.RMQServer`` (open-loop Poisson
  arrivals); the deadline micro-batcher coalesces them into power-of-two
  padded engine launches, scatters per-request results back, and EVERY
  request is verified bit-identical against the oracle. Prints p50/p99
  latency, sustained throughput, and the microbatch/coalescing profile.

The engine runs on ``--device`` (default ``cuda``; it fails when CUDA is
absent, it does not fall back). Engine choices and flag validation derive
from the registry's capability metadata; builds lower through the staged
BuildPlan pipeline, whose resolved threshold drives per-regime warmup in
async mode. Port of ``repro/launch/serve.py`` for the single-device
engines; the flags of later slices (--calibrate, --tune, --packed,
--qshard, --mutate, --restore, --chaos, --replicas) are not ported yet.

  PYTHONPATH=src python -m repro_torch.launch.serve --n 67108864 \
      --batch 4096 --batches 8 --dist small --engine hybrid
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --engine hybrid --n 67108864 --clients 4 --requests 32 --req-batch 256
"""

from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time

import numpy as np
import torch

from repro_torch._device import resolve, to_numpy
from repro_torch.core import build as build_mod
from repro_torch.core import ref, registry
from repro_torch.obs import Tracer, set_tracer, verify_request_chains
from repro_torch.serve import RMQServer, ServeConfig
from repro_torch.serve.workload import make_queries, run_poisson_clients

__all__ = ["main"]


def _parser() -> argparse.ArgumentParser:
    engines = registry.serveable_names()
    ap = argparse.ArgumentParser(
        description="Serve batched RMQs through any registry engine.",
        epilog="engines: " + "; ".join(f"{n} — {registry.get(n).doc}" for n in engines),
    )
    ap.add_argument("--mode", choices=["oneshot", "async"], default="oneshot")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--dist", choices=["large", "medium", "small"], default="small")
    ap.add_argument("--engine", choices=engines, default="hybrid")
    ap.add_argument("--device", default="cuda", help="torch device the engine runs on (cuda | cpu)")
    ap.add_argument(
        "--block-size",
        type=int,
        default=None,
        help="engine block size (engines declaring a 'block_size' build kwarg; "
        "default: the engine's own)",
    )
    one = ap.add_argument_group("oneshot")
    one.add_argument("--batch", type=int, default=4096, help="queries per batch")
    one.add_argument("--batches", type=int, default=8, help="batches to serve")
    one.add_argument("--verify", type=int, default=64, help="oracle sample size")
    asy = ap.add_argument_group("async")
    asy.add_argument("--clients", type=int, default=4, help="concurrent simulated clients")
    asy.add_argument("--requests", type=int, default=32, help="requests per client")
    asy.add_argument("--req-batch", type=int, default=16, help="queries per request")
    asy.add_argument(
        "--rate",
        type=float,
        default=200.0,
        help="per-client offered load, Poisson requests/s (0 = no pacing)",
    )
    asy.add_argument("--deadline-ms", type=float, default=2.0, help="micro-batch deadline")
    asy.add_argument("--max-batch", type=int, default=4096, help="queries per engine launch")
    asy.add_argument("--workers", type=int, default=1, help="engine-pool threads")
    asy.add_argument("--max-pending", type=int, default=4096, help="admission-control bound")
    asy.add_argument(
        "--adaptive-deadline",
        action="store_true",
        help="let the batcher shrink its deadline under load and grow it when idle",
    )
    obs = ap.add_argument_group("observability")
    obs.add_argument(
        "--trace",
        default=None,
        metavar="OUT.json",
        help="record request/build lifecycle spans and export a Chrome-trace "
        "JSON here; async mode additionally self-verifies that every served "
        "request has a complete admission->flush->launch->scatter->resolve "
        "span chain",
    )
    obs.add_argument(
        "--metrics-interval",
        type=float,
        default=None,
        metavar="S",
        help="dump the metrics registry as one JSON line every S seconds "
        "(plus a final dump at shutdown)",
    )
    return ap


def _build_kwargs(ap, args, spec: registry.EngineSpec) -> dict:
    """Flag validation straight off the EngineSpec capability metadata."""
    kw = {}
    if args.block_size is not None:
        if "block_size" not in spec.build_kwargs:
            ap.error(
                f"--block-size requires an engine with a 'block_size' build kwarg; "
                f"{args.engine} declares {sorted(spec.build_kwargs) or '()'}"
            )
        kw["block_size"] = args.block_size
    return kw


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_oneshot(args, spec, state, x, rng, device) -> bool:
    total_q = 0
    last = None
    t0 = time.perf_counter()
    for _ in range(args.batches):
        l, r = make_queries(rng, args.n, args.batch, args.dist)
        idx, val = spec.query(state, l, r)
        last = (l, r, idx, val)
        total_q += args.batch
    _sync(device)
    t_serve = time.perf_counter() - t0

    l, r, idx, val = last
    k = min(args.verify, args.batch)
    gold = ref.rmq_ref(x, l[:k], r[:k])
    idx_h = to_numpy(idx[:k])
    ok = bool((idx_h == gold).all() and (to_numpy(val[:k]) == x[gold]).all())
    print(
        f"[{args.engine}] served {total_q} RMQs over n={args.n} "
        f"({args.dist} ranges) on 1 device ({device}): "
        f"serve {t_serve*1e3:.1f} ms ({t_serve/total_q*1e9:.1f} ns/RMQ), "
        f"verify[{k}] {'OK' if ok else 'MISMATCH'}"
    )
    return ok


def _run_async(args, spec, state, x, plan, device) -> bool:
    cfg = ServeConfig(
        deadline_s=args.deadline_ms * 1e-3,
        max_batch=args.max_batch,
        max_pending=args.max_pending,
        workers=args.workers,
        n=args.n,
        val_dtype=x.dtype,
        adaptive_deadline=args.adaptive_deadline,
    )
    qfn = lambda l, r: spec.query(state, l, r)
    srv = RMQServer(
        qfn,
        cfg,
        warmup_bounds=build_mod.warmup_bounds(plan),
        trace_attrs=_span_attrs(args.engine, plan),
    )
    srv.warmup()  # every padded launch shape, per plan regime

    with _metrics_dump(args.metrics_interval, srv.metrics.snapshot), srv:
        t0 = time.perf_counter()
        per_client = run_poisson_clients(
            args.clients,
            args.requests,
            args.rate,
            lambda rng, c: make_queries(rng, args.n, args.req_batch, args.dist),
            srv.submit,
            seed=10_000,
        )
        done = []
        dropped = 0
        for out in per_client:
            for (l, r), fut in out:
                if fut is None:
                    dropped += 1
                else:
                    done.append((l, r, fut.result(timeout=300)))
        wall = time.perf_counter() - t0  # serving only: verification is below
    st = srv.stats()

    served = len(done)
    mismatches = 0
    for l, r, res in done:
        gold = ref.rmq_ref(x, l, r)
        if not (np.array_equal(res.idx, gold) and np.array_equal(res.val, x[gold])):
            mismatches += 1

    print(
        f"[async {args.engine}] {args.clients} clients x {args.requests} reqs "
        f"x {args.req_batch} RMQs ({args.dist} ranges, {args.rate:g} req/s/client, "
        f"deadline {args.deadline_ms:g} ms) on 1 device ({device}), "
        f"{wall*1e3:.0f} ms wall"
    )
    print(f"  {st.summary()}")
    print(
        f"  verify: {served - mismatches}/{served} requests bit-identical to the "
        f"oracle; dropped {dropped}"
    )
    return mismatches == 0 and served > 0


def _span_attrs(engine: str, plan) -> dict:
    """Static launch-span attrs derived from the resolved BuildPlan: the
    engine, routing threshold, and kernel config every exported launch span
    carries."""
    attrs = {"engine": engine, "layout": "unpacked"}
    meta = plan.meta
    if meta.get("threshold") is not None:
        attrs["threshold"] = int(meta["threshold"])
    if meta.get("block_size") is not None:
        attrs["block_size"] = int(meta["block_size"])
    kcfg = meta.get("kernel_config")
    if kcfg is not None:
        attrs["kernel_tile"] = int(kcfg.tile)
        attrs["fetch"] = str(kcfg.fetch)
        attrs["kernel_block_size"] = int(kcfg.block_size)
    return attrs


@contextlib.contextmanager
def _metrics_dump(interval, snapshot_fn):
    """Periodic one-line JSON dumps of ``snapshot_fn()`` every ``interval``
    seconds (daemon thread), plus a final dump on exit. No-op when
    ``interval`` is None."""
    if interval is None:
        yield
        return
    stop = threading.Event()

    def loop():
        while not stop.wait(interval):
            try:
                print("[metrics] " + json.dumps(snapshot_fn()))
            except Exception as e:  # a dump must never kill serving
                print(f"[metrics] dump failed: {e!r}")

    t = threading.Thread(target=loop, daemon=True, name="metrics-dump")
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join(interval + 1.0)
        print("[metrics] final " + json.dumps(snapshot_fn()))


def _export_trace(path: str, tracer, *, expect_requests: bool) -> bool:
    """Export the trace + self-verify request chains; False on a gap."""
    n = tracer.export(path)
    complete, problems = verify_request_chains(tracer.spans())
    extra = f", {tracer.dropped} spans dropped by ring buffer" if tracer.dropped else ""
    print(f"[trace] {n} spans -> {path} ({complete} complete request chains{extra})")
    ok = True
    if problems:
        for p in problems[:10]:
            print(f"[trace] INCOMPLETE: {p}")
        if len(problems) > 10:
            print(f"[trace] ... and {len(problems) - 10} more")
        ok = False
    if expect_requests and complete == 0:
        print("[trace] FAIL: no complete request chains recorded")
        ok = False
    return ok


def main(argv=None) -> None:
    ap = _parser()
    args = ap.parse_args(argv)
    spec = registry.get(args.engine)
    kw = _build_kwargs(ap, args, spec)
    device = resolve(args.device)

    tracer = None
    if args.trace is not None:
        # Install globally BEFORE the build so build stage spans and the
        # serving layer all land in the same ring buffer.
        tracer = Tracer(enabled=True, capacity=1 << 17)
        set_tracer(tracer)
    try:
        ok = _run_modes(args, spec, kw, device)
    finally:
        if tracer is not None:
            set_tracer(None)
    if tracer is not None:
        ok = _export_trace(args.trace, tracer, expect_requests=args.mode == "async") and ok
    if not ok:
        raise SystemExit(1)


def _run_modes(args, spec, kw, device) -> bool:
    rng = np.random.default_rng(0)
    x = rng.random(args.n, dtype=np.float32)

    # The staged BuildPlan resolves everything static (device, threshold,
    # kernel geometry) before touching the array; async warmup reads the
    # plan's regimes instead of guessing.
    plan = registry.plan_for_serving(args.engine, args.n, device, **kw)
    t0 = time.perf_counter()
    state = build_mod.execute(plan, x)
    _sync(device)
    kcfg = plan.meta.get("kernel_config")
    kmsg = (
        f", kernel tile={kcfg.tile} fetch={kcfg.fetch} bs={kcfg.block_size}"
        if kcfg is not None
        else ""
    )
    print(
        f"[{args.engine}] build {((time.perf_counter() - t0))*1e3:.1f} ms "
        f"(n={args.n}, {plan.layout.num_shards} structure shard(s) x "
        f"{plan.layout.shard_len} cols{kmsg})"
    )
    if args.mode == "oneshot":
        return _run_oneshot(args, spec, state, x, rng, device)
    return _run_async(args, spec, state, x, plan, device)


if __name__ == "__main__":
    main()
