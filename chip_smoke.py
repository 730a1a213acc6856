"""Smoke run of repro_torch on one CUDA card: kernels, served path, numbers.

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and nvcc versions,
   and the build of the CUDA kernels from ``src/repro_torch/csrc``;
2. ``block_min`` kernel vs its plain PyTorch version at nb = 2^19 rows,
   bs in {128, 256}, float32 and tie-heavy int32: values and lanes equal;
3. ``fused_query`` kernel vs plain, ``resident`` at n = 2^20 and ``dma`` at
   n = 2^26 (and each fetch at the other size), B in {4096, 4099}: indices
   and values equal, and the two fetches equal;
4. the served path through ``repro_torch.launch.serve.main``: hybrid and
   fused128 oneshot at n = 2^26, hybrid oneshot at n = 2^20 (where the
   resident fetch serves), hybrid async at n = 2^26 with small and medium
   ranges, every request checked against the numpy oracle. The launch
   counts are set to 0 just before each of these runs and read just after;
   each kernel must have launched in them;
5. one JSON ``kernels`` line, the card line again, and the last line
   ``{"ok": true, "device": {...}}``.

Times are medians of CUDA-event timings (ms). ``bound_ms`` is the larger of
the bytes the call must move over 3.35 TB/s and its operations over the
card's peak (67 TFLOP/s float32 outside the tensor cores; tiny here), from
this run's inputs. Tolerance of every comparison: exact.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
N_MAIN = 1 << 26  # the served array: 2^26 float32 values
N_RESIDENT = 1 << 20  # nb = 2^13 blocks of 128: the largest "auto" resident size


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    import numpy as np

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _kernel_ms(torch, fn, name: str, iters: int = 20):
    """Device time of one launch of the kernel whose name holds ``name``,
    from ``torch.profiler`` (mean over ``iters`` launches); None when the
    profiler records no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key]
    count = sum(e.count for e in hits)
    if not count:
        return None
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _max_abs_err(torch, a, b) -> float:
    return float((a.double() - b.double()).abs().max().item()) if a.numel() else 0.0


def _queries(rng, n: int, b: int):
    """Lengths uniform in [1, 8192], plus a full-range and two l == r queries."""
    import numpy as np

    length = rng.integers(1, min(8192, n) + 1, b)
    l = rng.integers(0, n - length + 1)
    r = l + length - 1
    l[:3] = [0, 7, n - 1]
    r[:3] = [n - 1, 7, n - 1]
    return l.astype(np.int32), r.astype(np.int32)


def _fq_bytes(l, r, bs: int, itemsize: int, fetch: str) -> int:
    """Bytes one fused_query call must move for these queries: the elements
    of each partial range, the interior cells, the bounds and the outputs."""
    import numpy as np

    l = l.astype(np.int64)
    r = r.astype(np.int64)
    bl, br = l // bs, r // bs
    ls, re = l - bl * bs, r - br * bs
    le = np.where(bl == br, re, bs - 1)
    elems = (le - ls + 1) + np.where(br > bl, re + 1, 0)
    cell = 2 * (itemsize + 4) if fetch == "dma" else 2 * 4 + 2 * (itemsize + 4)
    hasint = (br - bl) >= 2
    return int(elems.sum() * itemsize + hasint.sum() * cell + l.size * (8 + 4 + itemsize))


def _device_busy_share(torch, np, dev) -> None:
    """The async hybrid ``small`` run again, its client window traced with
    ``torch.profiler`` (device activity only): the device's busy and idle
    share of the window, and its busiest kernels. The profiler slows the
    host, so this run reports no latency."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import build as build_mod
    from repro_torch.core import registry
    from repro_torch.serve import RMQServer, ServeConfig
    from repro_torch.serve.workload import make_queries, run_poisson_clients

    x = np.random.default_rng(0).random(N_MAIN, dtype=np.float32)
    plan = registry.plan_for_serving("hybrid", N_MAIN, dev)
    state = build_mod.execute(plan, x)
    spec = registry.get("hybrid")
    srv = RMQServer(
        lambda l, r: spec.query(state, l, r),
        ServeConfig(n=N_MAIN),
        warmup_bounds=build_mod.warmup_bounds(plan),
    )
    srv.warmup()
    with srv, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per_client = run_poisson_clients(
            4, 32, 200.0, lambda rng, c: make_queries(rng, N_MAIN, 256, "small"), srv.submit,
            seed=10_000,
        )
        for out in per_client:
            for _, fut in out:
                _require(fut is not None and fut.result(timeout=300).idx.size == 256, "traced run")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in events)
    print(
        f"[trace] async hybrid small, n={N_MAIN}: device busy {busy_us / 1e3:.3f} ms of "
        f"{wall_us / 1e3:.3f} ms client window (busy share {busy_us / wall_us:.4f}, "
        f"idle share {1 - busy_us / wall_us:.4f}; {srv.stats().n_batches} launches)"
    )
    for e in events[:6]:
        print(f"[trace]   {e.self_device_time_total / 1e3:.3f} ms in {e.count} x {e.key[:90]}")


def main() -> int:
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.block_min import block_min, block_min_plain
    from repro_torch.kernels.fused_query import fused_query, fused_query_plain
    from repro_torch.launch import serve

    # --- phase 1: card, versions, kernel build ------------------------------
    card = _card_line()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    print(f"[card] {card}")
    print(
        f"[versions] torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"nvcc {nvcc.stdout.strip().splitlines()[-1]}; device {torch.cuda.get_device_name(0)}"
    )
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds} s)")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            print(f"[build]   {line.strip()}")

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    kernels = {}

    # --- phase 2: block_min -------------------------------------------------
    nb = 1 << 19
    for bs in (128, 256):
        for kind in ("f32", "i32"):
            if kind == "f32":
                xb = torch.from_numpy(rng.random(nb * bs, dtype=np.float32)).to(dev).reshape(nb, bs)
            else:
                xb = torch.from_numpy(rng.integers(0, 3, nb * bs).astype(np.int32)).to(dev).reshape(nb, bs)
            kv, ki = block_min(xb)
            pv, pi = block_min_plain(xb)
            torch.cuda.synchronize()
            _require(torch.equal(kv, pv) and torch.equal(ki, pi), f"block_min {kind} bs={bs} != plain")
            call_ms = _time_ms(torch, lambda: block_min(xb))
            ms = _kernel_ms(torch, lambda: block_min(xb), "block_min_kernel")
            plain_ms = _time_ms(torch, lambda: block_min_plain(xb))
            lib_ms = _time_ms(torch, lambda: torch.min(xb, dim=1))
            bound_ms = (nb * bs * 4 + nb * 8) / HBM_BYTES_PER_S * 1e3
            err = _max_abs_err(torch, kv, pv)
            print(
                f"[block_min] {kind} nb={nb} bs={bs}: equal to plain (max_abs_err {err}); "
                f"kernel {ms} ms on the device, {call_ms:.4f} ms per wrapper call; "
                f"plain {plain_ms:.4f} ms, torch.min {lib_ms:.4f} ms, bound {bound_ms:.4f} ms"
            )
            if kind == "f32" and bs == 128:  # the served shape: n = 2^26 float32
                kernels["block_min"] = dict(
                    ms=ms if ms is not None else call_ms, call_ms=call_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, library_ms=lib_ms, max_abs_err=err,
                )
            del xb, kv, ki, pv, pi

    # --- phase 3: fused_query -----------------------------------------------
    for n, own in ((N_RESIDENT, "resident"), (N_MAIN, "dma")):
        for kind in ("f32", "i32"):
            if kind == "f32":
                x = rng.random(n, dtype=np.float32)
            else:
                x = rng.integers(0, 3, n).astype(np.int32)
            s = ops.build(x, 128, device=dev)
            nbk = s.x_blocks.shape[0]
            for b in (4096, 4099):
                l, r = _queries(rng, n, b)
                lt = torch.from_numpy(l).to(dev)
                rt = torch.from_numpy(r).to(dev)
                args = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt)
                tables = dict(st_val=s.st_val, st_gidx=s.st_gidx)
                out = {}
                for fetch in ("resident", "dma"):
                    ki, kv = fused_query(*args, **tables, fetch=fetch)
                    pi, pv = fused_query_plain(*args, **tables, fetch=fetch)
                    torch.cuda.synchronize()
                    _require(
                        torch.equal(ki, pi) and torch.equal(kv, pv),
                        f"fused_query {fetch} {kind} n={n} B={b} != plain",
                    )
                    out[fetch] = (ki, kv)
                    if fetch != own or b != 4096:
                        continue
                    call = lambda: fused_query(*args, **tables, fetch=fetch)
                    call_ms = _time_ms(torch, call)
                    ms = _kernel_ms(torch, call, "fused_query_kernel")
                    plain_ms = _time_ms(
                        torch, lambda: fused_query_plain(*args, **tables, fetch=fetch)
                    )
                    bound_ms = _fq_bytes(l, r, 128, 4, fetch) / HBM_BYTES_PER_S * 1e3
                    err = _max_abs_err(torch, kv, pv)
                    print(
                        f"[fused_query] {fetch} {kind} n={n} nb={nbk} B={b}: equal to plain "
                        f"(max_abs_err {err}); kernel {ms} ms/batch on the device, "
                        f"{call_ms:.4f} ms per wrapper call; plain {plain_ms:.4f} ms, "
                        f"bound {bound_ms:.6f} ms"
                    )
                    if kind == "f32":
                        kernels[f"fused_query[{fetch}]"] = dict(
                            ms=ms if ms is not None else call_ms, call_ms=call_ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, library_ms=None, max_abs_err=err,
                        )
                _require(
                    torch.equal(out["resident"][0], out["dma"][0])
                    and torch.equal(out["resident"][1], out["dma"][1]),
                    f"fused_query resident != dma ({kind} n={n} B={b})",
                )
                print(f"[fused_query] {kind} n={n} B={b}: resident == dma == plain")
            del s

    # --- phase 4: the served path -------------------------------------------
    counts = {"block_min": 0, "fused_query[resident]": 0, "fused_query[dma]": 0}

    def drive(argv):
        block_min.launches = 0
        fused_query.launches = 0
        fused_query.launches_by_fetch = {"resident": 0, "dma": 0}
        serve.main(argv)  # prints verify[...] OK / verify: k/k; exits 1 on a mismatch
        run = {
            "block_min": block_min.launches,
            "fused_query[resident]": fused_query.launches_by_fetch["resident"],
            "fused_query[dma]": fused_query.launches_by_fetch["dma"],
        }
        _require(run["block_min"] > 0 and fused_query.launches > 0, f"kernels not launched by {argv}")
        for k, v in run.items():
            counts[k] += v
        print(f"[served] launches {json.dumps(run)}")

    oneshot = ["--mode", "oneshot", "--batch", "4096", "--batches", "8", "--dist", "small"]
    drive([*oneshot, "--engine", "hybrid", "--n", str(N_MAIN)])
    drive([*oneshot, "--engine", "fused128", "--n", str(N_MAIN)])
    drive([*oneshot, "--engine", "hybrid", "--n", str(N_RESIDENT)])
    torch.cuda.reset_peak_memory_stats()
    for dist in ("small", "medium"):
        drive(
            [
                "--mode", "async", "--engine", "hybrid", "--n", str(N_MAIN),
                "--clients", "4", "--requests", "32", "--req-batch", "256", "--dist", dist,
            ]
        )
    print(f"[served] max_memory_allocated {torch.cuda.max_memory_allocated()} bytes (async hybrid, n={N_MAIN})")
    for name, c in counts.items():
        _require(c > 0, f"{name} was not launched on the served path")
    _device_busy_share(torch, np, dev)

    # --- phase 5: the kernels line and the result ---------------------------
    source = {
        "block_min": ("src/repro_torch/csrc/block_min.cu", "src/repro/kernels/block_min.py:47"),
        "fused_query[resident]": ("src/repro_torch/csrc/fused_query.cu", "src/repro/kernels/fused_query.py:310"),
        "fused_query[dma]": ("src/repro_torch/csrc/fused_query.cu", "src/repro/kernels/fused_query.py:310"),
    }
    rows = []
    for name, m in kernels.items():
        src, replaces = source[name]
        rows.append(
            {
                "name": name,
                "route": "cuda",
                "source": src,
                "replaces": replaces,
                "launches": counts[name],
                "max_abs_err": m["max_abs_err"],
                "ms": m["ms"],
                "call_ms": m["call_ms"],
                "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"],
                "bound_by": "bytes",
                "library_ms": m["library_ms"],
            }
        )
    _require(len(rows) == 3, "a kernel has no measurement")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
