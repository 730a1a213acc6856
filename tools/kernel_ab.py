"""Time the query kernels of one checkout's repro_torch on the card, warm and cold.

    python3 tools/kernel_ab.py [--src DIR] [--label NAME] [--lane-queries Q]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``)
and the timing helpers of this checkout's ``chip_smoke.py``, so two trees
are timed by one piece of code. To compare a parent commit with the working
tree on one card, unpack the parent into a directory that ``.gitignore``
lists and run the two in turns (parent, change, change, parent) on the
same card, one after another:

    mkdir -p build/parent && git archive <parent> src | tar -x -C build/parent
    for t in parent change change parent; do
        src=src; [ $t = parent ] && src=build/parent/src
        python3 tools/kernel_ab.py --label $t --src $src
    done

Rows, one batch of B = 4096 queries with lengths uniform in [1, 8192]
(``chip_smoke._queries``) unless named otherwise, tile 8 unless named:
- float32: ``fused_query`` resident and dma at n = 2^20 and n = 2^26,
  quantized ``fused_query_packed``, ``rmq_partials`` and ``lane_partials``
  at n = 2^26; ``fused_query`` dma at n = 2^26 also for the first 1, 64
  and 512 queries of the batch and at tiles 4, 16 and 32; ``lane_partials`` also for lengths uniform in
  [1, 128] (about half inside one lane block), for one query, at tiles 1
  and 4, and for a batch whose every query lies inside one lane block
  (blocks uniform, both ends uniform in the block) at tiles 8 and 1;
- packed32 ``fused_query_packed``: resident at n = 2^20 (int32 in
  [-24, 24], key span 49), dma on the Euler-tour depths of
  ``chip_smoke.euler_depths`` (n = 2^26 - 3), each also for one query.
- the long path at n = 10^8 float32, 2^22 lengths uniform in [1, n]: the
  plain chain (``sparse_table.query``, then the value gather; ``call_ms``
  and ``device_ms``, the device time of all its kernels) and, in a tree
  that has it, the ``sparse_query`` kernel (``equal``: to the chain).

For each, ``chip_smoke.kernel_times``: ``ms``
(device time, the batch launched again and again, so L2 is warm),
``cold_ms`` (L2 flushed before every launch) and ``call_ms`` (one wrapper
call, host work included); the ``lane_partials`` rows also say whether the
kernel equals its plain version bit for bit (``equal``). Then the host cost
of the parts of one ``fused_query`` dma call at n = 2^26, in microseconds
from ``time.perf_counter_ns``. Prints the card line and one JSON line,
which also holds ``-Xptxas -v``'s spill and register lines for
``lane_partials.cu`` when this run built the kernels.

``--lane-queries Q`` builds the kernels with ``-DREPRO_LANE_QUERIES=Q``, so
``csrc/lane_partials.cu`` gives a warp Q queries instead of its default 4
(into a build directory of its own: the flags are part of the build key),
to time that choice with the same rows.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per_call_us(torch, fn, reps: int = 2000, sync_every: int = 64) -> float:
    """Mean host time of ``fn()`` in microseconds; the card is synchronised
    every ``sync_every`` calls, outside the timed spans, so launches never
    wait on a full queue."""
    fn()
    torch.cuda.synchronize()
    total = 0
    for i in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        total += time.perf_counter_ns() - t0
        if (i + 1) % sync_every == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return total / reps / 1e3


def host_parts(torch, s, lt, rt, fused_query, lib) -> dict:
    """What one ``fused_query`` dma call spends on the host, part by part:
    the call as a whole, then each thing the wrapper does, alone."""
    dev = s.x_blocks.device
    nb, bs = s.x_blocks.shape
    b = lt.shape[0]
    leaves = (s.x_blocks, s.st_val, s.st_gidx)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    val = torch.empty(b, dtype=torch.float32, device=dev)
    fn = lib.repro_fused_query_f32
    kind = "f32"
    lock = threading.Lock()
    box = [0]

    def launch():
        fn(s.x_blocks.data_ptr(), None, None, None, s.st_val.data_ptr(), s.st_gidx.data_ptr(),
           lt.data_ptr(), rt.data_ptr(), idx.data_ptr(), val.data_ptr(), b, nb, bs, 1, 8,
           torch.cuda.current_stream().cuda_stream)

    def checks():
        for t in leaves:
            if t.dtype not in (torch.float32, torch.int32) or t.device != dev or t.ndim != 2 or not t.is_contiguous():
                raise ValueError

    def count():
        with lock:
            box[0] += 1

    def own_device_stream():
        if dev.index is None or dev.index == torch.cuda.current_device():
            return torch.cuda.current_stream().cuda_stream
        raise ValueError

    def device_context_stream():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream().cuda_stream

    parts = {
        "fused_query call": lambda: fused_query(
            s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt,
            st_val=s.st_val, st_gidx=s.st_gidx, fetch="dma",
        ),
        "bounds to int32 on the card (x2)": lambda: (
            lt.to(device=dev, dtype=torch.int32), rt.to(device=dev, dtype=torch.int32)
        ),
        "leaf checks (x3)": checks,
        "torch.empty outputs (x2)": lambda: (
            torch.empty(b, dtype=torch.int32, device=dev), torch.empty(b, dtype=torch.float32, device=dev)
        ),
        "data_ptr (x8)": lambda: [t.data_ptr() for t in (*leaves, lt, rt, idx, val, s.x_blocks)],
        "getattr on an f-string": lambda: getattr(lib, f"repro_fused_query_{kind}"),
        "torch.cuda.device context + stream": device_context_stream,
        "current-device test + stream": own_device_stream,
        "ctypes call (the launch)": launch,
        "launch count under a lock": count,
    }
    return {name: per_call_us(torch, f) for name, f in parts.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src directory holding repro_torch")
    ap.add_argument("--label", default="change")
    ap.add_argument("--lane-queries", type=int, choices=(1, 2, 4, 8), default=None,
                    help="queries per warp of lane_partials (default: the source's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    # chip_smoke puts this checkout's src first and imports repro_torch from
    # it: put --src back in front and drop what came from this checkout.
    sys.path.insert(0, str(Path(args.src).resolve()))
    for name in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    from repro_torch.core import lane_rmq
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused_query import fused_query, fused_query_packed
    from repro_torch.kernels.lane_query import lane_partials, lane_partials_plain
    from repro_torch.kernels.rmq_query import rmq_partials

    dev = torch.device("cuda")
    card = cs._card_line()
    if args.lane_queries is not None:
        _build._FLAGS = (*_build._FLAGS, f"-DREPRO_LANE_QUERIES={args.lane_queries}")
    lib = _build.library()
    log = _build.build_log or ""
    lane_ptxas = [
        line.strip()
        for line in log.split("--- lane_partials.cu", 1)[-1].split("\n--- ", 1)[0].splitlines()
        if "registers" in line or "spill" in line
    ] if "--- lane_partials.cu" in log else None
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    rows = {}
    for n, seed in ((cs.N_RESIDENT, 1), (cs.N_MAIN, 2)):
        x = np.random.default_rng(seed).random(n, dtype=np.float32)
        l, r = cs._queries(np.random.default_rng(seed + 10), n, 4096)
        lt, rt = torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev)
        s = ops.build(x, 128, device=dev)
        for fetch in ("resident", "dma"):
            call = lambda: fused_query(
                s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt,
                st_val=s.st_val, st_gidx=s.st_gidx, fetch=fetch,
            )
            rows[f"fused_query[{fetch}] n=2^{n.bit_length() - 1}"] = cs.kernel_times(
                torch, call, "fused_query_kernel", flush
            )
        if n != cs.N_MAIN:
            continue
        # What the batch's width costs: one query alone, narrower batches,
        # and other tiles.
        for b in (1, 64, 512):
            lb, rb = lt[:b], rt[:b]
            rows[f"fused_query[dma] n=2^26 B={b}"] = cs.kernel_times(
                torch,
                lambda: fused_query(
                    s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lb, rb,
                    st_val=s.st_val, st_gidx=s.st_gidx, fetch="dma",
                ),
                "fused_query_kernel",
                flush,
            )
        for tile in (4, 16, 32):
            rows[f"fused_query[dma] n=2^26 tile={tile}"] = cs.kernel_times(
                torch,
                lambda: fused_query(
                    s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, lt, rt,
                    st_val=s.st_val, st_gidx=s.st_gidx, fetch="dma", tile=tile,
                ),
                "fused_query_kernel",
                flush,
            )
        parts = host_parts(torch, s, lt, rt, fused_query, lib)
        bl, br = lt // 128, rt // 128
        ls, re = lt - bl * 128, rt - br * 128
        pargs = (s.x_blocks, bl, br, ls, torch.where(bl == br, re, 127), re)
        rows["rmq_partials n=2^26"] = cs.kernel_times(
            torch, lambda: rmq_partials(*pargs), "rmq_partials_kernel", flush
        )
        del s
        q, spec = ops.build_packed(x, 128, layout="quantized", device=dev)
        rows["fused_query_packed[quantized] n=2^26"] = cs.kernel_times(
            torch,
            lambda: fused_query_packed(q.blocks, q.stw, lt, rt, spec=spec, bmin_val=q.bmin_val),
            "QuantizedCells",
            flush,
        )
        del q
        lanes = lane_rmq.build(x, device=dev)
        planes = (lanes.xs, lanes.suff_val, lanes.suff_idx, lanes.pref_val, lanes.pref_idx)
        short = [torch.from_numpy(a).to(dev) for a in cs._queries(np.random.default_rng(20), n, 4096, 128)]
        brng = np.random.default_rng(30)
        blk = brng.integers(0, n // 128, 4096)
        lo, hi = brng.integers(0, 128, 4096), brng.integers(0, 128, 4096)
        inside = [
            torch.from_numpy((blk * 128 + e).astype(np.int32)).to(dev)
            for e in (np.minimum(lo, hi), np.maximum(lo, hi))
        ]
        for tag, (lq, rq), tile in (
            ("", (lt, rt), 8),
            (" lengths<=128", short, 8),
            (" B=1", (lt[:1], rt[:1]), 8),
            (" tile=1", (lt, rt), 1),
            (" tile=4", (lt, rt), 4),
            (" same-block", inside, 8),
            (" same-block tile=1", inside, 1),
        ):
            largs = (*planes, lq // 128, rq // 128, lq % 128, rq % 128)
            row = cs.kernel_times(
                torch, lambda: lane_partials(*largs, tile=tile), "lane_partials_kernel", flush
            )
            got, want = lane_partials(*largs, tile=tile), lane_partials_plain(*largs)
            row["equal"] = all(
                torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)
            )
            rows[f"lane_partials n=2^26{tag}"] = row
        del lanes, planes
    # packed32: resident at n = 2^20 (int32 in [-24, 24], key span 49), dma
    # on the Euler-tour depths (n = 2^26 - 3); each also for one query.
    for x, fetch, tag in (
        (np.random.default_rng(3).integers(-24, 25, cs.N_RESIDENT).astype(np.int32), "resident", "n=2^20"),
        (cs.euler_depths(cs.EULER_HEIGHT), "dma", "Euler n=2^26-3"),
    ):
        l, r = cs._queries(np.random.default_rng(13), x.size, 4096)
        lt, rt = torch.from_numpy(l).to(dev), torch.from_numpy(r).to(dev)
        p, spec = ops.build_packed(x, 128, layout="packed32", device=dev)
        for b, btag in ((4096, ""), (1, " B=1")):
            rows[f"fused_query_packed[packed32,{fetch}] {tag}{btag}"] = cs.kernel_times(
                torch,
                lambda: fused_query_packed(p.blocks, p.stw, lt[:b], rt[:b], spec=spec, fetch=fetch),
                "fused_query_packed32_kernel",
                flush,
            )
        del p
    # The long path at the benchmark cell's size, n = 10^8 float32 and 2^22
    # lengths uniform in [1, n]: the plain chain (``sparse_table.query``,
    # then the value gather) in every tree, and the ``sparse_query`` kernel
    # where the tree has it, checked equal to the chain.
    from repro_torch.core import sparse_table

    gen = torch.Generator(device=dev).manual_seed(4)
    n, q = cs.N_LONG, 1 << 22
    x = torch.rand(n, generator=gen, device=dev)
    st = sparse_table.build(x)
    length = torch.randint(1, n + 1, (q,), generator=gen, device=dev)
    lo = torch.minimum((torch.rand(q, generator=gen, device=dev, dtype=torch.float64) * (n - length + 1)).long(), n - length)
    lt, rt = lo.int(), (lo + length - 1).int()

    def chain():
        i = sparse_table.query(st, lt, rt)
        return i, x[i]

    rows["sparse_table.query chain n=10^8 B=2^22"] = dict(
        call_ms=cs._time_ms(torch, chain), device_ms=cs.all_kernels_ms(torch, chain)
    )
    try:
        from repro_torch.kernels.sparse_query import sparse_query
    except ImportError:  # a tree without the kernel
        sparse_query = None
    if sparse_query is not None:
        row = cs.kernel_times(torch, lambda: sparse_query(st.idx, x, lt, rt), "sparse_query_kernel", flush)
        got, want = sparse_query(st.idx, x, lt, rt), chain()
        row["equal"] = all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
        rows["sparse_query n=10^8 B=2^22"] = row
    del st, x
    print(card)
    print(json.dumps({
        "label": args.label, "src": args.src, "lane_queries": args.lane_queries, "card": card,
        "rows": rows, "host_us": parts, "lane_ptxas": lane_ptxas,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
