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
  With ``--mutate K`` (engines declaring ``updatable``), a mutator thread
  interleaves K update batches (point writes, range fills, appends) through
  ``submit_update`` while the clients run: the engine is built as a
  ``repro_torch.update.OnlineEngine``, each request is answered against its
  pinned MVCC version, and verification replays the delta stream on the
  host so every request is checked against the oracle **of its version**.
  With ``--restore DIR`` the online engine is a
  ``repro_torch.fault.DurableEngine`` rooted at DIR: every update batch is
  journaled before it applies, and a later run restores DIR's latest
  checkpoint plus its journal suffix instead of building (the root's
  format is the reference's, so either package resumes the other's).

``--chaos SEED`` runs the seeded chaos soak (``repro_torch.fault.chaos``)
instead of serving: worker crashes, a failed patch and a failed checkpoint
mid-stream, then a crash-restore that must be bit-identical; it exits 1
unless the report is ``[OK]``. ``--mutate``, ``--restore`` and ``--chaos``
take the mesh engines too, on the CLI's mesh.

``--replicas N`` (async, updatable engines) serves through a replica fleet
(``repro_torch.serve.fleet``): N serving stacks behind one regime-routing,
read-your-writes front door, each ``--mutate`` batch rolled out to every
replica within ``--max-lag`` versions, every request verified against the
oracle of the version it was answered at. A mesh engine's replicas carve
the visible cards (``--device cpu``: one CPU position each).

The engine runs on ``--device`` (default ``cuda``; it fails when CUDA is
absent, it does not fall back). Engine choices and flag validation derive
from the registry's capability metadata; builds lower through the staged
BuildPlan pipeline, whose resolved threshold drives per-regime warmup in
async mode. ``--packed`` serves packed (value, index) word structures
(engines declaring a ``packed`` build kwarg, e.g. ``packed_hybrid``); the
build line names the layout the data resolved to. Engines declaring a
``threshold`` build kwarg read their routing threshold from the calibration
cache (``core.calib_cache``, ``RMQ_TORCH_CALIB_CACHE``), and ``--calibrate``
measures it there on a miss; engines declaring ``kernel_config`` read their
kernel geometry from it, and ``--tune`` sweeps on a miss. The build line
names the resolved threshold and geometry, and the time resolving them took.
The mesh engines (``distributed``, ``sharded_hybrid``,
``packed_sharded_hybrid``) build over a mesh of the ``--device``'s cards
(``core.build.default_mesh``: every visible card for ``cuda``, one shard
for ``cpu``); ``--qshard`` shards the query batch (``shard_batch``) and
``--qshard 2d`` factors the cards into a (structure, batch) grid
(``shard_2d``, which a one-card mesh degrades to ``shard_structure``).
Port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --n 67108864 \
      --batch 4096 --batches 8 --dist small --engine hybrid
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --engine hybrid --n 67108864 --clients 4 --requests 32 --req-batch 256
  PYTHONPATH=src python -m repro_torch.launch.serve --engine packed_hybrid \
      --packed quantized --n 67108864
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --engine hybrid --calibrate --tune --n 67108864
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --engine hybrid --mutate 8 --n 67108864
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --engine hybrid --mutate 4 --restore durable_root --n 1048576
  PYTHONPATH=src python -m repro_torch.launch.serve --chaos 7 \
      --engine hybrid --n 1048576
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --engine sharded_hybrid --qshard 2d --n 67108864
  PYTHONPATH=src python -m repro_torch.launch.serve --mode async \
      --engine hybrid --replicas 3 --max-lag 2 --mutate 4 --n 16777216
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time

import numpy as np
import torch

from repro_torch import update as update_mod
from repro_torch._device import resolve, to_numpy
from repro_torch.core import build as build_mod
from repro_torch.core import ref, registry
from repro_torch.launch.mesh import factor_2d, make_mesh
from repro_torch.obs import Tracer, set_tracer, verify_request_chains
from repro_torch.serve import RMQServer, ServeConfig, ServerOverloaded
from repro_torch.serve.workload import make_queries, run_poisson_clients

__all__ = ["main"]

# --qshard values -> sharded_hybrid distribution modes.
_QSHARD_MODES = {"batch": "shard_batch", "2d": "shard_2d"}


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
    ap.add_argument(
        "--packed",
        nargs="?",
        const="auto",
        choices=["auto", "packed32", "packed64", "quantized"],
        default=None,
        help="serve packed (value, index) word structures (core.packing): bare "
        "--packed (= 'auto') picks the tightest layout the data fits, or name "
        "one explicitly (engines declaring a 'packed' build kwarg)",
    )
    ap.add_argument(
        "--qshard",
        nargs="?",
        const="batch",
        choices=sorted(_QSHARD_MODES),
        default=None,
        help="shard the query batch: bare --qshard (= 'batch') replicates the "
        "structure and shards queries over the mesh; '--qshard 2d' shards the "
        "structure over one mesh axis and the batch over the other (engines "
        "declaring the matching mode)",
    )
    ap.add_argument(
        "--calibrate",
        action="store_true",
        help="routing threshold from the calibration cache, measuring once per "
        "configuration (engines declaring a 'threshold' build kwarg)",
    )
    ap.add_argument(
        "--tune",
        action="store_true",
        help="kernel launch geometry (tile, fetch, block size) from the "
        "autotune cache, sweeping once per configuration (engines declaring "
        "a 'kernel_config' build kwarg; without --tune, cached winners are "
        "still loaded read-only)",
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
        "--replicas",
        type=int,
        default=1,
        help="replica fleet size: >1 serves through serve.fleet's regime-"
        "routing front door (updatable engines; mesh engines carve one "
        "device group per replica)",
    )
    asy.add_argument(
        "--max-lag",
        type=int,
        default=1,
        help="fleet rollout barrier: max version spread between replicas",
    )
    asy.add_argument(
        "--mutate",
        type=int,
        default=0,
        metavar="K",
        help="interleave K update batches (point/range writes + appends) "
        "while serving (engines declaring 'updatable'); every request is "
        "verified against the oracle of its pinned version",
    )
    asy.add_argument(
        "--mutate-rate",
        type=float,
        default=50.0,
        help="mutator offered load, update batches/s",
    )
    asy.add_argument(
        "--adaptive-deadline",
        action="store_true",
        help="let the batcher shrink its deadline under load and grow it when idle",
    )
    asy.add_argument(
        "--restore",
        default=None,
        metavar="DIR",
        help="durability root (with --mutate): restore the engine from DIR's "
        "latest checkpoint + journal suffix if one exists, else create it "
        "there; every update is WAL-journaled before it applies",
    )
    ap.add_argument(
        "--chaos",
        type=int,
        default=None,
        metavar="SEED",
        help="run the seeded chaos soak instead of serving: crash workers, "
        "fail patches and checkpoints mid-stream, then crash-restore and "
        "verify nothing was lost (engines declaring 'updatable')",
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
    if args.qshard is not None and _QSHARD_MODES[args.qshard] not in spec.modes:
        ap.error(
            f"--qshard {args.qshard} requires an engine with a "
            f"'{_QSHARD_MODES[args.qshard]}' mode; "
            f"{args.engine} declares modes {spec.modes or '()'}"
        )
    for flag, on, kwarg in (
        ("--block-size", args.block_size is not None, "block_size"),
        ("--packed", args.packed is not None, "packed"),
        ("--calibrate", args.calibrate, "threshold"),
        ("--tune", args.tune, "kernel_config"),
    ):
        if on and kwarg not in spec.build_kwargs:
            ap.error(
                f"{flag} requires an engine with a '{kwarg}' build kwarg; "
                f"{args.engine} declares {sorted(spec.build_kwargs) or '()'}"
            )
    if args.packed == "quantized" and spec.needs_mesh:
        ap.error(
            "--packed quantized is single-host only (its exact fallback needs "
            f"the raw blocks resident); {args.engine} is a mesh engine"
        )
    if args.mutate:
        if args.mode != "async":
            ap.error("--mutate requires --mode async")
        if not spec.updatable:
            ap.error(
                f"--mutate requires an updatable engine; "
                f"{args.engine} is not (have {registry.updatable_names()})"
            )
    if args.replicas > 1:
        if args.mode != "async":
            ap.error("--replicas > 1 requires --mode async")
        if not spec.updatable:
            ap.error(
                f"--replicas > 1 requires an updatable engine; "
                f"{args.engine} is not (have {registry.updatable_names()})"
            )
        if args.chaos is not None:
            ap.error("--chaos runs a single-engine soak; drop --replicas")
    if args.chaos is not None and not spec.updatable:
        ap.error(
            f"--chaos requires an updatable engine; "
            f"{args.engine} is not (have {registry.updatable_names()})"
        )
    if args.restore is not None and not args.mutate and args.chaos is None:
        ap.error("--restore requires --mutate (durable online serving) or --chaos")
    kw = {}
    if args.block_size is not None:
        kw["block_size"] = args.block_size
    if "threshold" in spec.build_kwargs:
        kw["threshold"] = "calibrated" if args.calibrate else "cached"
    if "kernel_config" in spec.build_kwargs:
        kw["kernel_config"] = "tuned" if args.tune else "cached"
    if args.packed is not None:
        kw["packed"] = args.packed
    if args.qshard is not None:
        kw["mode"] = _QSHARD_MODES[args.qshard]
    return kw


def _serve_mesh(args, spec: registry.EngineSpec, device):
    """``{"mesh": ..., "axis_names": ...}`` for a mesh engine, else ``{}``.

    ``--qshard 2d`` factors the cards into the squarest (struct, qbatch)
    grid; everything else gets the default all-cards 1-D mesh.
    """
    if not spec.needs_mesh:
        return {}
    mesh, axes = registry.default_mesh(device)
    ndev = len(mesh.physical_devices)
    if args.qshard == "2d" and ndev > 1:
        axes = ("struct", "qbatch")
        mesh = make_mesh(factor_2d(ndev), axes, devices=mesh.physical_devices)
    return {"mesh": mesh, "axis_names": axes}


def _where(device, mesh_kw) -> str:
    """Where the engine runs, for the result lines: one device, or a mesh's
    shards and the devices they sit on."""
    mesh = mesh_kw.get("mesh")
    if mesh is None:
        return f"1 device ({device})"
    return f"{mesh.size} shard(s) on {len(mesh.physical_devices)} device(s) ({mesh.physical_devices[0]})"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_oneshot(args, spec, state, x, rng, where: str) -> bool:
    total_q = 0
    last = None
    t0 = time.perf_counter()
    for _ in range(args.batches):
        l, r = make_queries(rng, args.n, args.batch, args.dist)
        idx, val = spec.query(state, l, r)
        last = (l, r, idx, val)
        total_q += args.batch
    _sync(idx.device)
    t_serve = time.perf_counter() - t0

    l, r, idx, val = last
    k = min(args.verify, args.batch)
    gold = ref.rmq_ref(x, l[:k], r[:k])
    idx_h = to_numpy(idx[:k])
    ok = bool((idx_h == gold).all() and (to_numpy(val[:k]) == x[gold]).all())
    mode = f" qshard={args.qshard}" if args.qshard else ""
    print(
        f"[{args.engine}{mode}] served {total_q} RMQs over n={args.n} "
        f"({args.dist} ranges) on {where}: "
        f"serve {t_serve*1e3:.1f} ms ({t_serve/total_q*1e9:.1f} ns/RMQ), "
        f"verify[{k}] {'OK' if ok else 'MISMATCH'}"
    )
    return ok


def _run_async(args, spec, state, x, plan, where: str, online=None) -> bool:
    cfg = ServeConfig(
        deadline_s=args.deadline_ms * 1e-3,
        max_batch=args.max_batch,
        max_pending=args.max_pending,
        workers=args.workers,
        n=args.n,
        val_dtype=x.dtype,
        adaptive_deadline=args.adaptive_deadline,
    )
    okw = dict(warmup_bounds=build_mod.warmup_bounds(plan), trace_attrs=_span_attrs(args.engine, plan))
    if online is not None:
        srv = RMQServer(config=cfg, online=online, **okw)
    else:
        srv = RMQServer(lambda l, r: spec.query(state, l, r), cfg, **okw)
    srv.warmup()  # every padded launch shape, per plan regime
    base_vid = online.current_vid if online is not None else 0

    upd_futs = []

    def mutator():
        # Open-loop Poisson mutator: point writes every batch, a range fill
        # every 3rd, an append every 4th; overload rejections are dropped.
        mrng = np.random.default_rng(77)
        for i in range(args.mutate):
            if args.mutate_rate > 0:
                time.sleep(mrng.exponential(1.0 / args.mutate_rate))
            cur_n = online.n
            log = update_mod.DeltaLog()
            for _ in range(3):
                log.point(int(mrng.integers(0, cur_n)), float(mrng.random()))
            if i % 3 == 1 and cur_n > 2:
                a = int(mrng.integers(0, cur_n - 1))
                log.fill(a, min(a + 63, cur_n - 1), float(mrng.random()))
            if i % 4 == 3:
                log.append(mrng.random(32, dtype=np.float32))
            try:
                upd_futs.append((log, srv.submit_update(log)))
            except ServerOverloaded:
                pass

    with _metrics_dump(args.metrics_interval, srv.metrics.snapshot), srv:
        t0 = time.perf_counter()
        mut = None
        if online is not None and args.mutate:
            mut = threading.Thread(target=mutator, name="mutator")
            mut.start()
        per_client = run_poisson_clients(
            args.clients,
            args.requests,
            args.rate,
            lambda rng, c: make_queries(rng, args.n, args.req_batch, args.dist),
            srv.submit,
            seed=10_000,
        )
        if mut is not None:
            mut.join()
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

    # Replay the delta stream on the host: one oracle array per published
    # version (submission order == publish order: single updater thread).
    oracles = {base_vid: x}
    results = []
    if upd_futs:
        xm = x.copy()
        for log, fut in upd_futs:
            res = fut.result(timeout=300)
            xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
            oracles[res.version] = xm.copy()
            results.append(res)

    served = len(done)
    mismatches = 0
    for l, r, res in done:
        ox = oracles[res.version if res.version is not None else base_vid]
        gold = ref.rmq_ref(ox, l, r)
        if not (np.array_equal(res.idx, gold) and np.array_equal(res.val, ox[gold])):
            mismatches += 1

    mode = f" qshard={args.qshard}" if args.qshard else ""
    print(
        f"[async {args.engine}{mode}] {args.clients} clients x {args.requests} reqs "
        f"x {args.req_batch} RMQs ({args.dist} ranges, {args.rate:g} req/s/client, "
        f"deadline {args.deadline_ms:g} ms) on {where}, "
        f"{wall*1e3:.0f} ms wall"
    )
    print(f"  {st.summary()}")
    if results:
        patched = sum(res.patched for res in results)
        print(
            f"  mutate: {len(results)} update batches applied "
            f"({patched} patched, {len(results) - patched} rebuilt), n {args.n} -> {online.n}, "
            f"{len(oracles)} oracle versions"
        )
        for res in results:
            print(
                f"  update v{res.version}: {'patched' if res.patched else 'rebuilt'}, "
                f"{res.n_writes} writes + {res.n_appended} appended, n={res.n}, "
                f"apply {res.seconds*1e3:.1f} ms, publish_bytes {res.publish_bytes}"
            )
        lags = np.unique(np.asarray(st.version_lags, np.int64), return_counts=True)
        print(f"  version lags (lag: launches): {dict(zip(lags[0].tolist(), lags[1].tolist()))}")
        vids = np.unique([res.version for _, _, res in done], return_counts=True)
        print(f"  served versions (vid: requests): {dict(zip(vids[0].tolist(), vids[1].tolist()))}")
    print(
        f"  verify: {served - mismatches}/{served} requests bit-identical to the "
        f"oracle of their pinned version; dropped {dropped}"
    )
    ok = mismatches == 0 and served > 0
    if args.mutate:
        ok = ok and len(upd_futs) > 0
    return ok


def _run_fleet(args, spec, x, kw, device) -> bool:
    """Serve through a replica fleet (``serve.fleet``): regime-routed front
    door, bounded-lag rollouts, per-version oracle verification — the
    multi-replica twin of ``_run_async``."""
    from repro_torch.serve.fleet import FleetConfig, RMQFleet, cli_placement

    scfg = ServeConfig(
        deadline_s=args.deadline_ms * 1e-3,
        max_batch=args.max_batch,
        max_pending=args.max_pending,
        workers=args.workers,
        adaptive_deadline=args.adaptive_deadline,
        max_retries=4,
    )
    fcfg = FleetConfig(replicas=args.replicas, max_version_lag=args.max_lag, server=scfg)
    t0 = time.perf_counter()
    fleet = RMQFleet.build(
        args.engine,
        x,
        config=fcfg,
        durable_root=args.restore,
        **cli_placement(args.engine, device, None, args.replicas),
        **kw,
    )
    base_vid = fleet.head_vid
    fleet.warmup()
    where = sorted({str(d) for rep in fleet.replicas for d in (rep.mesh.physical_devices if rep.mesh else (rep.device,))})
    print(
        f"[{args.engine} x{args.replicas}] fleet build+warmup "
        f"{(time.perf_counter() - t0)*1e3:.1f} ms (threshold {fleet.threshold}, "
        f"lag bound {fcfg.max_version_lag}, "
        f"affinities {list(fcfg.resolved_affinities())})"
    )

    upd_futs = []
    sess = fleet.session()

    def mutator():
        # Same open-loop Poisson mutator as the single-server path, but each
        # batch rolls out fleet-wide through the session (read-your-writes).
        mrng = np.random.default_rng(77)
        for i in range(args.mutate):
            if args.mutate_rate > 0:
                time.sleep(mrng.exponential(1.0 / args.mutate_rate))
            cur_n = fleet.head_n
            log = update_mod.DeltaLog()
            for _ in range(3):
                log.point(int(mrng.integers(0, cur_n)), float(mrng.random()))
            if i % 3 == 1 and cur_n > 2:
                a = int(mrng.integers(0, cur_n - 1))
                log.fill(a, min(a + 63, cur_n - 1), float(mrng.random()))
            if i % 4 == 3:
                log.append(mrng.random(32, dtype=np.float32))
            try:
                upd_futs.append((log, fleet.submit_update(log, session=sess)))
            except ServerOverloaded:
                pass

    with _metrics_dump(args.metrics_interval, fleet.metrics), fleet:
        t0 = time.perf_counter()
        mut = None
        if args.mutate:
            mut = threading.Thread(target=mutator, name="mutator")
            mut.start()
        per_client = run_poisson_clients(
            args.clients,
            args.requests,
            args.rate,
            lambda rng, c: make_queries(rng, args.n, args.req_batch, args.dist),
            fleet.submit,
            seed=10_000,
        )
        if mut is not None:
            mut.join()
        done = []
        dropped = 0
        for out in per_client:
            for (l, r), fut in out:
                if fut is None:
                    dropped += 1
                else:
                    done.append((l, r, fut.result(timeout=300)))
        settled = fleet.wait_settled(timeout=300)
        wall = time.perf_counter() - t0
        st = fleet.stats()

    # Per-version host oracles, as in _run_async: the fleet assigns vids in
    # submission order, so the replay below matches every replica.
    oracles = {base_vid: x}
    patched = rebuilt = 0
    if upd_futs:
        xm = x.copy()
        for log, fut in upd_futs:
            res = fut.result(timeout=300)
            xm = log.coalesce(xm.shape[0], xm.dtype).apply_numpy(xm)
            oracles[res.version] = xm.copy()
            patched += res.patched
            rebuilt += not res.patched

    served = len(done)
    mismatches = 0
    for l, r, res in done:
        ox = oracles[res.version if res.version is not None else base_vid]
        gold = ref.rmq_ref(ox, l, r)
        if not (np.array_equal(res.idx, gold) and np.array_equal(res.val, ox[gold])):
            mismatches += 1

    print(
        f"[fleet {args.engine} x{args.replicas}] {args.clients} clients x "
        f"{args.requests} reqs x {args.req_batch} RMQs ({args.dist} ranges, "
        f"{args.rate:g} req/s/client) on {len(where)} device(s) {where}, "
        f"{wall*1e3:.0f} ms wall"
    )
    print(f"  {st.summary()}")
    if done:
        total = np.array([res.timing.total_s for _, _, res in done])
        print(
            f"  latency: p50 {np.percentile(total, 50)*1e3:.2f} ms p99 "
            f"{np.percentile(total, 99)*1e3:.2f} ms over {total.size} requests (replica submit -> answer)"
        )
    if upd_futs:
        print(
            f"  mutate: {len(upd_futs)} rollouts ({patched} patched, {rebuilt} "
            f"rebuilt), n {args.n} -> {fleet.head_n}, settled={settled}, "
            f"session floor v{sess.last_vid}"
        )
    print(
        f"  verify: {served - mismatches}/{served} requests bit-identical to the "
        f"oracle of their pinned version; dropped {dropped}"
    )
    ok = mismatches == 0 and served > 0 and settled
    if args.mutate:
        ok = ok and len(upd_futs) > 0
    return ok


def _span_attrs(engine: str, plan) -> dict:
    """Static launch-span attrs derived from the resolved BuildPlan: the
    engine, routing threshold, and kernel config every exported launch span
    carries."""
    meta = plan.meta
    layout = meta.get("packed")
    attrs = {"engine": engine, "layout": str(layout) if layout is not None else "unpacked"}
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
    # A mesh engine's placement (its mesh) takes the place of the device.
    mesh_kw = _serve_mesh(args, spec, device)
    where = mesh_kw or {"device": device}

    if args.chaos is not None:
        from repro_torch.fault import chaos as chaos_mod

        report = chaos_mod.run_soak(
            engine=args.engine,
            n=args.n,
            seed=args.chaos,
            root=args.restore,
            workers=args.workers,
            log=print,
            **where,
        )
        print(report.summary())
        return bool(report.ok)
    if args.replicas > 1:
        # The fleet carves its own per-replica devices (RMQFleet.build).
        return _run_fleet(args, spec, x, kw, device)
    if args.mutate:
        # Online build: the OnlineEngine plans + builds version 0 and owns
        # the MVCC store; the server pins versions per launch. With
        # --restore, the engine is durable: WAL-journaled updates rooted at
        # DIR, resumed from its checkpoint + journal when one exists.
        t0 = time.perf_counter()
        if args.restore is not None:
            from repro_torch import checkpoint as ckpt_mod
            from repro_torch.fault import DurableEngine

            if ckpt_mod.latest_step(os.path.join(args.restore, "ckpt")) is not None:
                online = DurableEngine.restore(args.restore, **where)
                x = np.asarray(online.store.current.x_host)
                args.n = online.n
                print(
                    f"[{args.engine}] restored from {args.restore}: "
                    f"version {online.current_vid}, seq {online.seq}, "
                    f"n={online.n} ({online.replayed} journal records replayed)"
                )
            else:
                online = DurableEngine.create(args.engine, x, args.restore, **where, **kw)
        else:
            online = update_mod.make_online(args.engine, x, **where, **kw)
        for d in mesh_kw["mesh"].physical_devices if mesh_kw else (device,):
            _sync(d)
        plan = online.plan
        print(
            f"[{args.engine}] online build {((time.perf_counter() - t0))*1e3:.1f} ms "
            f"(n={args.n}, {plan.layout.num_shards} structure shard(s) x "
            f"{plan.layout.shard_len} cols, threshold {plan.meta.get('threshold')}, "
            f"version {online.current_vid})"
        )
        return _run_async(args, spec, None, x, plan, _where(device, mesh_kw), online=online)

    # The staged BuildPlan resolves everything static (device, threshold,
    # kernel geometry: a cache read, or a measurement on a --calibrate or
    # --tune miss) before touching the array; async warmup reads the plan's
    # regimes instead of guessing.
    t0 = time.perf_counter()
    plan = registry.plan_for_serving(args.engine, args.n, device, **mesh_kw, **kw)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = build_mod.execute(plan, x)
    for d in mesh_kw["mesh"].physical_devices if mesh_kw else (device,):
        _sync(d)
    pspec = registry.packed_spec(state)
    thr = plan.meta.get("threshold")
    kcfg = plan.meta.get("kernel_config")
    msg = f", threshold {thr}" if thr is not None else ""
    if kcfg is not None:
        msg += f", kernel tile={kcfg.tile} fetch={kcfg.fetch} bs={kcfg.block_size}"
    print(
        f"[{args.engine}] build {((time.perf_counter() - t0))*1e3:.1f} ms "
        f"(n={args.n}, {plan.layout.num_shards} structure shard(s) x "
        f"{plan.layout.shard_len} cols, layout "
        f"{pspec.layout if pspec is not None else plan.meta.get('packed') or 'unpacked'}{msg}; "
        f"plan {t_plan*1e3:.1f} ms)"
    )
    where = _where(device, mesh_kw)
    if args.mode == "oneshot":
        return _run_oneshot(args, spec, state, x, rng, where)
    return _run_async(args, spec, state, x, plan, where)


if __name__ == "__main__":
    main()
