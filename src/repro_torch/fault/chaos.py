"""Chaos soak: mutate-while-serving under a seeded fault plan, oracle-verified.

The end-to-end crash-safety gate. One soak drives an ``RMQServer`` over a
``DurableEngine`` while a deterministic ``FaultPlan`` injects failures at
every seam the subsystem defends:

* **worker_query crashes** — a launch dies AND takes its worker thread with
  it; the supervisor restarts the slot, the batch's requests retry.
* **patch_apply errors** — an update fails after the mirrors were patched
  (the diverged-state window); the engine fail-stops, the journaled seq is
  abort-marked, and the soak recovers in place (checkpoint + journal-suffix
  replay) before resubmitting.
* **checkpoint_write errors** — a mid-soak checkpoint dies after its leaf
  files are written but before the manifest; the torn temp directory is
  ignored and the journal stays uncompacted, so restore still works.

Every query response is verified against a host-side oracle **pinned to the
version it was answered against** (``RequestResult.version``), so a stale
answer, a torn update, or a mixed-version batch is caught as a mismatch —
not averaged away. After the traffic the live engine is abandoned
(simulated crash: only the on-disk root survives) and restored; the soak
asserts the restored structure is bit-identical to the live one, equals a
from-scratch rebuild of the oracle array, and keeps answering correctly.

Run it standalone, on the card or (``--device cpu``) on the host::

    PYTHONPATH=src python -m repro_torch.fault.chaos --engine hybrid --seed 7

Not imported from ``repro_torch.fault`` — this module pulls in
``repro_torch.serve``. Port of ``repro/fault/chaos.py`` for the eight
updatable engines: the same plan, mutator and report; the engines run on
``device``, the mesh engines on ``mesh`` (the CLI: ``device``'s default
mesh).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch._device import to_numpy
from repro_torch.checkpoint.store import _flatten
from repro_torch.core import registry
from repro_torch.core.distributed import ShardedLeaf
from repro_torch.fault.durable import DurableEngine
from repro_torch.fault.inject import FaultPlan, FaultSpec
from repro_torch.serve import RMQServer, ServeConfig
from repro_torch.update import DeltaLog
from repro_torch.update.engines import OnlineEngine, online_names

__all__ = ["SoakReport", "default_plan", "run_soak", "main"]


def _struct_leaves(online) -> list:
    """The current version's tensor leaves as host arrays, in the
    reference's tree order (ints, specs and closures skipped)."""
    return [
        to_numpy(leaf)
        for _, leaf in _flatten(online.store.current.state)
        if isinstance(leaf, (torch.Tensor, ShardedLeaf))
    ]


def _leaves_equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b)
    )


class SoakReport(NamedTuple):
    engine: str
    seed: int
    requests: int  # client requests submitted
    queries: int  # individual RMQs across those requests
    updates_applied: int  # successfully published update batches
    update_failures: int  # injected apply failures (each recovered + resubmitted)
    recoveries: int  # in-place DurableEngine.recover() calls
    failed_checkpoints: int  # injected checkpoint-write failures
    oracle_mismatches: int  # responses disagreeing with their version's oracle
    lost_requests: int  # requests that failed instead of answering
    worker_restarts: int
    retried_requests: int
    degraded_launches: int
    breaker_trips: int
    restore_replayed: int  # journal records replayed by the post-crash restore
    restore_vid_ok: bool  # restored version id continues the live timeline
    restore_identical: bool  # restored leaves == live leaves, bit for bit
    restore_equals_rebuild: bool  # restored leaves == from-scratch rebuild
    restore_serves: bool  # restored server answers oracle-correct
    elapsed_s: float

    @property
    def ok(self) -> bool:
        return (
            self.oracle_mismatches == 0
            and self.lost_requests == 0
            and self.restore_vid_ok
            and self.restore_identical
            and self.restore_equals_rebuild
            and self.restore_serves
        )

    def summary(self) -> str:
        return (
            f"[{'OK' if self.ok else 'FAIL'}] {self.engine} seed={self.seed}: "
            f"{self.requests} reqs / {self.queries} RMQs, "
            f"{self.updates_applied} updates ({self.update_failures} injected apply "
            f"failures -> {self.recoveries} recoveries), "
            f"{self.failed_checkpoints} failed checkpoints, "
            f"{self.worker_restarts} worker restarts, {self.retried_requests} retried, "
            f"{self.degraded_launches} degraded, breaker x{self.breaker_trips}; "
            f"mismatches={self.oracle_mismatches} lost={self.lost_requests}; "
            f"restore: replayed={self.restore_replayed} vid_ok={self.restore_vid_ok} "
            f"identical={self.restore_identical} rebuild={self.restore_equals_rebuild} "
            f"serves={self.restore_serves}; {self.elapsed_s:.1f}s"
        )


def default_plan(seed: int) -> FaultPlan:
    """The standard soak plan: every defended seam fires at least once.

    ``worker_query`` crashes probabilistically (supervisor + retry path);
    ``patch_apply`` fails exactly the 2nd apply (poison -> recover path);
    ``checkpoint_write`` fails exactly the 2nd snapshot — the base checkpoint
    at create() is invocation 1, so the mid-soak checkpoint dies first try.
    """
    return FaultPlan(
        seed,
        {
            "worker_query": FaultSpec(rate=0.04, kind="crash"),
            "patch_apply": FaultSpec(at=(2,)),
            "checkpoint_write": FaultSpec(at=(2,)),
        },
    )


def _mutate(rng: np.random.Generator, cur: np.ndarray):
    """One random update batch + the expected post-update oracle array."""
    n = cur.shape[0]
    log = DeltaLog()
    new = cur.copy()
    op = rng.integers(0, 3)
    if op == 0:  # point writes
        for i in rng.integers(0, n, size=int(rng.integers(1, 5))):
            v = float(rng.standard_normal())
            log.point(int(i), v)
            new[int(i)] = np.float32(v)
    elif op == 1:  # constant range fill
        l = int(rng.integers(0, n))
        r = min(n - 1, l + int(rng.integers(0, 64)))
        v = float(rng.standard_normal())
        log.fill(l, r, v)
        new[l : r + 1] = np.float32(v)
    else:  # append
        tail = rng.standard_normal(int(rng.integers(1, 33))).astype(np.float32)
        log.append(tail)
        new = np.concatenate([new, tail])
    return log, new


def run_soak(
    *,
    engine: str = "hybrid",
    n: int = 1 << 13,
    requests: int = 120,
    updates: int = 10,
    qbatch: int = 4,
    seed: int = 0,
    root: Optional[str] = None,
    workers: int = 2,
    device=None,
    mesh=None,
    axis_names=None,
    plan: Optional[FaultPlan] = None,
    log=None,
) -> SoakReport:
    """Run one seeded chaos soak; see the module docstring for what it proves.

    Deterministic given (seed, engine, n, requests, updates, qbatch): the
    same faults fire at the same invocations and the same mutations hit the
    same indices. Only thread interleaving varies — which is the point: the
    correctness conditions must hold under every interleaving. The engines
    run on ``device`` (``None``: CUDA), a mesh engine on ``mesh`` when one
    is given.
    """
    say = log if log is not None else (lambda *_: None)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    plan = plan if plan is not None else default_plan(seed)

    owned_root = root is None
    root = root if root is not None else tempfile.mkdtemp(prefix="rmq-chaos-")
    where = dict(device=device, mesh=mesh, axis_names=axis_names)
    durable = DurableEngine.create(engine, x, root, fault=plan, **where)
    cfg = ServeConfig(
        workers=workers,
        deadline_s=5e-4,
        max_retries=12,  # crashes are retryable: nothing may be lost
        breaker_threshold=4,
        breaker_cooldown_s=0.02,
    )
    srv = RMQServer(online=durable, fault_plan=plan, config=cfg).start()

    # Host-side oracle, one array per published version id.
    cur = x.copy()
    expected = {durable.current_vid: cur.copy()}
    updates_applied = update_failures = recoveries = failed_ckpts = 0
    mismatches = lost = nreq = nq = 0
    update_every = max(1, requests // max(updates, 1))
    pending = []  # (l, r, future)

    def drain():
        nonlocal mismatches, lost, nreq, nq
        for l, r, fut in pending:
            nreq += 1
            nq += l.size
            try:
                res = fut.result(timeout=120)
            except Exception as e:
                lost += 1
                say(f"LOST request: {e!r}")
                continue
            ox = expected.get(res.version)
            if ox is None:  # a version we never published: silently wrong
                mismatches += l.size
                say(f"unknown version {res.version}")
                continue
            for i in range(l.size):
                seg = ox[l[i] : r[i] + 1]
                if res.idx[i] != l[i] + int(np.argmin(seg)) or not np.array_equal(
                    res.val[i], seg[res.idx[i] - l[i]]
                ):
                    mismatches += 1
        pending.clear()

    for step in range(requests):
        if updates and step and step % update_every == 0:
            # Updates are barriers: drain outstanding queries first so the
            # oracle never races the publish (responses pin their version,
            # but waiting here keeps the soak loop simple and deterministic).
            drain()
            dlog, new = _mutate(rng, cur)
            for attempt in range(2):
                try:
                    res = srv.submit_update(dlog).result(timeout=120)
                    break
                except Exception as e:
                    # Injected patch_apply failure: the engine fail-stopped
                    # and the seq was abort-marked. Recover in place
                    # (checkpoint + journal-suffix replay) and resubmit.
                    update_failures += 1
                    say(f"update failed ({e!r}); recovering")
                    durable.recover(**where)
                    recoveries += 1
            else:
                raise RuntimeError("update failed twice; recovery did not clear it")
            cur = new
            expected[res.version] = cur.copy()
            updates_applied += 1
        if step == requests // 2:
            # Mid-soak checkpoint. The plan's checkpoint_write site may kill
            # it (torn temp dir, journal uncompacted) — restore must not care.
            drain()
            try:
                durable.checkpoint()
            except Exception as e:
                failed_ckpts += 1
                say(f"checkpoint failed ({e!r}); journal stays authoritative")
        nmax = cur.shape[0]
        l = rng.integers(0, nmax, qbatch).astype(np.int32)
        r = np.minimum(nmax - 1, l + rng.integers(0, nmax // 4, qbatch)).astype(np.int32)
        pending.append((l, r, srv.submit(l, r)))
    drain()

    st = srv.stats()
    pre_vid = durable.current_vid
    pre_leaves = _struct_leaves(durable.online)
    srv.close()
    # Simulated crash: abandon the live engine — only the on-disk root
    # (checkpoints + journal) survives into the restore.
    durable.close()

    restored = DurableEngine.restore(root, **where)
    restore_vid_ok = restored.current_vid == pre_vid
    post_leaves = _struct_leaves(restored.online)
    restore_identical = _leaves_equal(pre_leaves, post_leaves)
    rebuilt = OnlineEngine(engine, expected[pre_vid], **where)
    restore_equals_rebuild = _leaves_equal(post_leaves, _struct_leaves(rebuilt))

    # The restored engine must serve, not just compare equal.
    restore_serves = True
    srv2 = RMQServer(online=restored, config=ServeConfig(workers=1, deadline_s=5e-4)).start()
    ox = expected[pre_vid]
    l = rng.integers(0, ox.shape[0], 8).astype(np.int32)
    r = np.minimum(ox.shape[0] - 1, l + rng.integers(0, 256, 8)).astype(np.int32)
    try:
        res = srv2.submit(l, r).result(timeout=120)
        for i in range(8):
            seg = ox[l[i] : r[i] + 1]
            if res.idx[i] != l[i] + int(np.argmin(seg)):
                restore_serves = False
    except Exception:
        restore_serves = False
    srv2.close()
    restored.close()
    if owned_root:
        shutil.rmtree(root, ignore_errors=True)

    return SoakReport(
        engine=engine,
        seed=seed,
        requests=nreq,
        queries=nq,
        updates_applied=updates_applied,
        update_failures=update_failures,
        recoveries=recoveries,
        failed_checkpoints=failed_ckpts,
        oracle_mismatches=mismatches,
        lost_requests=lost,
        worker_restarts=st.worker_restarts,
        retried_requests=st.retried_requests,
        degraded_launches=st.degraded_launches,
        breaker_trips=st.breaker_trips,
        restore_replayed=restored.replayed,
        restore_vid_ok=restore_vid_ok,
        restore_identical=restore_identical,
        restore_equals_rebuild=restore_equals_rebuild,
        restore_serves=restore_serves,
        elapsed_s=time.perf_counter() - t0,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="seeded chaos soak over the crash-safe serve stack")
    p.add_argument("--engine", default="hybrid", choices=sorted(online_names()))
    p.add_argument("--n", type=int, default=1 << 13)
    p.add_argument("--requests", type=int, default=120)
    p.add_argument("--updates", type=int, default=10)
    p.add_argument("--qbatch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--root", default=None, help="durability root (default: temp dir)")
    p.add_argument("--device", default="cuda", help="torch device the engines run on (cuda | cpu)")
    p.add_argument("--json", default=None, help="write the report as JSON here")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    where = {"device": args.device}
    if registry.get(args.engine).needs_mesh:
        mesh, axis_names = registry.default_mesh(args.device)
        where = {"mesh": mesh, "axis_names": axis_names}
        if not args.quiet:
            print(f"mesh {mesh!r}")

    report = run_soak(
        engine=args.engine,
        n=args.n,
        requests=args.requests,
        updates=args.updates,
        qbatch=args.qbatch,
        seed=args.seed,
        workers=args.workers,
        root=args.root,
        log=None if args.quiet else print,
        **where,
    )
    print(report.summary())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report._asdict(), f, indent=2, default=str)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
