"""One run of one cell: set-up, the measured window, the traced slice, and
the check against the plain reference.

``run_cell`` takes a loaded ``spec.Cell`` and the device to run on; it does
not look for a card (``run.py`` does), so the tests drive it on the CPU with
small configurations and with faults planted in the program.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import numpy as np

from bench import queries, reference, roofline, spec

__all__ = ["ProgramEngine", "Sample", "run_cell"]

# What a traced slice keeps of a device operation's name.
_NAME_CHARS = 160


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class ProgramEngine:
    """The system under test: ``repro_torch``'s registry engine ``name``,
    built with the registry's own ``build`` (the sqrt(n) threshold and the
    default kernel geometry: no calibration or tuning cache is read)."""

    def __init__(self, name: str):
        from repro_torch.core import hybrid, registry

        self.spec = registry.get(name)
        self.record_splits = hybrid.record_splits

    def build(self, x, device):
        return self.spec.build(x, device=device)

    def query(self, state, l, r):
        return self.spec.query(state, l, r)

    def check(self, state, config: dict, device) -> None:
        """Raise unless the built state is the configuration's deployment."""
        got = {}
        if hasattr(state, "threshold"):
            got["threshold"] = int(state.threshold)
        if hasattr(state, "spec"):
            got["layout"] = "unpacked" if state.spec is None else state.spec.layout
        blocked = getattr(state, "blocked", None)
        for field in ("x_blocks", "blocks"):
            if hasattr(blocked, field):
                got["block_size"] = int(getattr(blocked, field).shape[-1])
                break
        want = dict(config.get("expect", {}))
        wrong = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
        if wrong:
            raise RuntimeError(f"the build is not the configuration's: (stated, built) {wrong}")
        if device.type == "cuda" and getattr(state, "use_kernels", True) is not True:
            raise RuntimeError("the build's short path does not run the CUDA kernels")


class Sample:
    """A reservoir of ``k`` of the window's answers, drawn from the seed:
    every batch of the window is as likely to be kept."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(spec.seed_for(seed, "sample"))
        self.items = []  # (window batch, pool index, answer)

    def offer(self, i: int, p: int, out) -> None:
        if len(self.items) < self.k:
            self.items.append((i, p, out))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = (i, p, out)


def _traced_slice(torch, loop, call, pool, sync, engine, count: int, first: int) -> dict:
    """``count`` more batches under ``torch.profiler``: device operations,
    host events, and the queries each path got (``record_splits``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    splits = [0, 0]

    def count_splits(n_short, n_long):
        splits[0] += n_short
        splits[1] += n_long

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    record = getattr(engine, "record_splits", None)
    with record(count_splits) if record else contextlib.nullcontext():
        with profile(activities=acts) as prof:
            with record_function("bench.slice"):
                win = loop.drive(call, pool, sync, count=count, first=first, span=record_function)
    device_events, host_events, lo, hi = [], [], None, None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name == "bench.slice":
                lo, hi = s, t
            if not e.is_async:
                host_events.append((e.name, s, t))
        elif e.device_type == DeviceType.CUDA:
            # Spans of record_function show on the device's timeline too.
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                continue
            device_events.append((e.name[:_NAME_CHARS], s, t))
    if lo is None:
        raise RuntimeError("the profiler recorded no bench.slice span")
    return {
        "batches": win["batches"],
        "queries": win["queries"],
        "short_queries": splits[0],
        "long_queries": splits[1],
        "device_events": device_events,
        "host_events": host_events,
        "lo_us": lo,
        "hi_us": hi,
    }


def _check(cell, seed: int, device, items) -> dict:
    """Every kept answer against the plain reference, from the array and the
    bounds made again from the seed (nothing the program held or built)."""
    cfg = cell.config
    x = spec.data_generator(cfg["data"])(cfg, seed, device)
    pool = queries.pool(cell.traffic, int(cfg["n"]), int(cfg["batch"]), seed, device)
    table = reference.build(x)
    idx_wrong = val_wrong = either = compared = 0
    answers = {}
    for _, p, (idx, val) in items:
        if p not in answers:
            answers[p] = reference.query(table, *pool[p])
        wi, wv, we = reference.compare(idx, val, *answers[p])
        idx_wrong += wi
        val_wrong += wv
        either += we
        compared += int(pool[p][0].shape[0])
    return {"idx_wrong": idx_wrong, "val_wrong": val_wrong, "wrong": either, "compared": compared}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *, engine=None, t_start=None, log=_stderr) -> dict:
    """One run of ``cell`` on ``device``: the result object, its keys in the
    order the line prints them (``checks`` last)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg, traffic = cell.config, cell.traffic
    n, size = int(cfg["n"]), int(cfg["batch"])
    loop = spec.loop(traffic["loop"])
    engine = ProgramEngine(cfg["engine"]) if engine is None else engine

    x = spec.data_generator(cfg["data"])(cfg, seed, dev)
    if tuple(x.shape) != (n,) or x.dtype != getattr(torch, cfg["dtype"]):
        raise RuntimeError(f"data {cfg['data']!r} made {tuple(x.shape)} {x.dtype}, want ({n},) {cfg['dtype']}")
    pool = queries.pool(traffic, n, size, seed, dev)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = engine.build(x, dev)
    sync()
    build_s = time.perf_counter() - t0
    if hasattr(engine, "check"):
        engine.check(state, cfg, dev)

    def call(l, r):
        return engine.query(state, l, r)

    # Warm-up: one batch (every batch has the one shape); the window goes on
    # through the pool from the next, so no answer it checks repeats the
    # warm-up's call.
    loop.drive(call, pool, sync, count=1)
    sample = Sample(int(traffic["check_batches"]), seed)
    setup_s = time.perf_counter() - t_start
    log(f"[bench] {cell.name} seed {seed}: build {build_s:.4f} s, set-up {setup_s:.4f} s")

    win = loop.drive(call, pool, sync, seconds=seconds, first=1, on_batch=sample.offer)
    sl = None
    if trace:
        sl = _traced_slice(torch, loop, call, pool, sync, engine, int(traffic["trace_batches"]), 1 + win["batches"])
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    p95 = float(np.percentile(win["batch_s"], 95))
    beyond = sum(b > p95 for b in win["batch_s"])
    b_ms = [b * 1e3 for b in win["batch_s"]]
    med_ms = float(np.median(b_ms))
    stalls = [(i, b) for i, b in enumerate(b_ms) if b > 10 * med_ms]
    log(
        f"[bench] window {win['seconds']:.4f} s: {win['batches']} batches of "
        f"{size}, {beyond} beyond the p95 of {p95 * 1e3:.4f} ms; batch ms "
        f"median {med_ms:.4f}, min {min(b_ms):.4f}, max {max(b_ms):.4f}, "
        f"first three {[round(b, 4) for b in b_ms[:3]]}; {len(stalls)} beyond 10x "
        f"the median, {sum(b for _, b in stalls) / 1e3:.4f} s in all, the first at "
        f"batches {[i for i, _ in stalls[:8]]}; peak {peak} B"
    )

    # The program's state goes before the reference runs (the peak is read).
    del call, state, pool, x
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = _check(cell, seed, dev, sample.items)
    expected = min(sample.k, win["batches"]) * size
    correct = got["idx_wrong"] == 0 and got["val_wrong"] == 0 and got["compared"] == expected > 0
    log(
        f"[bench] check: {got['compared']} answers of {len(sample.items)} window batches "
        f"(batches {sorted(i for i, _, _ in sample.items)}) against the reference in "
        f"{time.perf_counter() - t0:.4f} s"
    )

    ctx = {
        "config": cfg,
        "traffic": traffic,
        "setup_s": setup_s,
        "build_s": build_s,
        "window": win,
        "peak_bytes": peak,
        "slice": sl,
    }
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = spec.reader(m["name"])(ctx)
        if value is None:
            log(f"[bench] {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result = {
        "correct": bool(correct),
        "attempted": win["queries"],
        "failed": got["wrong"] + (expected - got["compared"]),
        "metrics": metrics,
        "device": device_info,
    }
    if sl is not None:
        lo, hi = sl["lo_us"], sl["hi_us"]
        device_info["busy_s"] = roofline.busy_seconds(sl["device_events"], lo, hi)
        device_info["window_s"] = (hi - lo) / 1e6
        by_name = {}
        for name, s, e in sl["device_events"]:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": roofline.idle_gaps(sl["device_events"], sl["host_events"], lo, hi),
        }
    result["checks"] = {
        "idx_wrong": {"value": got["idx_wrong"], "limit": 0},
        "val_wrong": {"value": got["val_wrong"], "limit": 0},
    }
    return result
