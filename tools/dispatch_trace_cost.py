"""What tracing costs ``core.hybrid.dispatch_by_length``, and how much of its
``dispatch`` span the four phase spans cover, on the card.

    python3 tools/dispatch_trace_cost.py [--n N] [--batch B] [--rounds P] [--pairs K] [--seed S]
                                         [--device cpu]

The benchmark cell ``hybrid_f32_1e8.large`` at its own size by default: n =
10^8 float32 from ``bench/data/uniform_f32.py``, batches of 2^22 from
``bench/traffic/large_b22.json`` (lengths uniform in [1, n]), the registry's
``hybrid``. ``P`` rounds of ``2K`` batches in a closed loop, each round under
one ``torch.profiler`` session (CPU and CUDA), every batch with the
program's spans on (``on``: ``record_function`` per span, CUDA events per
launch) or compiled out (``off``: ``Tracer.span`` patched to the shared
no-op context and ``obs.trace.tracing`` to False), in the order on, off,
off, on, ... A batch's host time runs from the call to its return, its
time to the answers synchronized.

Prints the card line and one JSON line: per side the median and quartiles
of both times; the cost of tracing per batch, as the difference of the
medians and as the median of the differences within each adjacent pair;
and from the ``on`` batches each phase's ms per batch, the phases' share
of each ``dispatch`` span (least and median), the bytes copied per batch
and each path's mean device time per launch (the program's own counters),
and which ``dispatch`` names reached the profiler's device timeline, and
which of those are not user annotations (the harness drops those).
``--device cpu`` rehearses the control flow at a small ``--n`` and
``--batch``; its times are the CPU's, no device's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("dispatch.bounds", "dispatch.partition", "dispatch.launch", "dispatch.scatter")


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    return {"median": q2, "q1": q1, "q3": q3}


def round_(torch, call, pool, sides, first, cuda, set_side):
    """One batch per entry of ``sides`` under one profiler session, each with
    tracing set to its side: host and batch seconds, and the events."""
    from torch.profiler import ProfilerActivity, profile

    host, batch = [], []
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        for i, side in enumerate(sides):
            l, r = pool[(first + i) % len(pool)]
            set_side(side)
            try:
                t0 = time.perf_counter()
                call(l, r)
                t1 = time.perf_counter()
            finally:
                set_side("on")
            if cuda:
                torch.cuda.synchronize()
            host.append(t1 - t0)
            batch.append(time.perf_counter() - t0)
    return host, batch, prof.events()


def coverage(events):
    """Per ``dispatch`` host event, the share of it its phase events cover;
    and each phase's summed µs."""
    from torch.autograd import DeviceType

    host = [(e.name, e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CPU]
    roots = sorted((s, t) for n, s, t in host if n == "dispatch")
    phases = [(n, s, t) for n, s, t in host if n in PHASES]
    shares = [sum(t - s for _, s, t in phases if a <= s and t <= b) / (b - a) for a, b in roots]
    per = {p: sum(t - s for n, s, t in phases if n == p) for p in PHASES}
    on_device = sorted({e.name for e in events if e.device_type == DeviceType.CUDA and e.name.startswith("dispatch")})
    annotated = sorted(
        {e.name for e in events if e.device_type == DeviceType.CUDA and e.name.startswith("dispatch")
         and not getattr(e, "is_user_annotation", False)}
    )
    return shares, per, len(roots), on_device, annotated


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10**8)
    ap.add_argument("--batch", type=int, default=2**22)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=2**31 + 29)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import queries, spec
    from repro_torch.core import registry
    from repro_torch.obs import metrics
    from repro_torch.obs import trace as obs_trace

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    cfg = {"n": args.n}
    x = spec.data_generator("uniform_f32")(cfg, args.seed, dev)
    traffic = json.loads((ROOT / "bench" / "traffic" / "large_b22.json").read_text())
    pool = queries.pool(traffic, args.n, args.batch, args.seed, dev)
    eng = registry.get("hybrid")
    state = eng.build(x, device=dev)
    call = lambda l, r: eng.query(state, l, r)  # noqa: E731
    call(*pool[0])
    if cuda:
        torch.cuda.synchronize()

    real_span, real_tracing = obs_trace.Tracer.span, obs_trace.tracing

    def set_side(side):
        if side == "on":
            obs_trace.Tracer.span, obs_trace.tracing = real_span, real_tracing
        else:
            obs_trace.Tracer.span = lambda self, name, **kw: obs_trace._NOOP_CTX
            obs_trace.tracing = lambda: False

    reg = metrics.reset_default_registry()
    sides = ["on", "off", "off", "on"] * (args.pairs // 2) + ["on", "off"] * (args.pairs % 2)
    times = {"on": {"host": [], "batch": []}, "off": {"host": [], "batch": []}}
    diffs, shares, per, roots, on_device, annotated = [], [], dict.fromkeys(PHASES, 0.0), 0, set(), set()
    first = 1
    for _ in range(args.rounds):
        host, batch, events = round_(torch, call, pool, sides, first, cuda, set_side)
        first += len(sides)
        for side, h, b in zip(sides, host, batch):
            times[side]["host"].append(h)
            times[side]["batch"].append(b)
        by_pair = [dict(zip(sides[i : i + 2], host[i : i + 2])) for i in range(0, len(sides), 2)]
        diffs += [p["on"] - p["off"] for p in by_pair]
        s, p, n_roots, od, an = coverage(events)
        shares += s
        roots += n_roots
        on_device |= set(od)
        annotated |= set(an)
        for k in PHASES:
            per[k] += p[k]
    on_batches = len(times["on"]["host"])
    batches = reg.counter_total("dispatch_batches_total")
    device_ms = {
        h.labels["path"]: h.mean() * 1e3 for name, h in reg.histograms() if name == "dispatch_path_device_s"
    }
    out = {
        "n": args.n,
        "batch": args.batch,
        "rounds": args.rounds,
        "pairs_per_round": args.pairs,
        "host_ms": {k: {q: v * 1e3 for q, v in quartiles(t["host"]).items()} for k, t in times.items()},
        "batch_ms": {k: {q: v * 1e3 for q, v in quartiles(t["batch"]).items()} for k, t in times.items()},
        "cost_ms_of_medians": (statistics.median(times["on"]["host"]) - statistics.median(times["off"]["host"])) * 1e3,
        "cost_ms_paired": {q: v * 1e3 for q, v in quartiles(diffs).items()},
        "phase_ms_per_batch": {k: v / 1e3 / on_batches for k, v in per.items()},
        "dispatch_spans": roots,
        "phase_share_min": min(shares) if shares else None,
        "phase_share_median": statistics.median(shares) if shares else None,
        "copy_mib_per_batch": reg.counter_total("dispatch_copy_bytes_total") / 2**20 / batches,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "path_device_ms": device_ms,
        "device_dispatch_names": sorted(on_device),
        "device_dispatch_names_not_annotations": sorted(annotated),
        "torch": torch.__version__,
    }
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        print(f"card: {card}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
