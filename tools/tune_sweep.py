"""Sweep the fused query kernel's launch geometry on the card: tiles and fetch.

    python3 tools/tune_sweep.py [--out build/tune_sweep.json]

Two tables, each kernel's device time from ``torch.profiler``, warm (the
same batch launched again and again) and cold (L2 flushed before every
launch), by ``chip_smoke.kernel_times``:

1. tiles: ``fused_query`` at tile 1 to 32 (warps, one query each, per
   thread block), both fetches, at n = 2^20 and 2^26 float32 (bs = 128);
2. fetch: ``resident`` against ``dma`` at tile 8, nb = 2^3 to 2^19 blocks
   (n = nb * 128).

Each on two batches of B = 4096: ``uniform`` (both bounds uniform in
[0, n), ordered: the batch ``tuning.sweep`` times) and ``short`` (lengths
uniform in [1, 8192], ``chip_smoke._queries``: the ranges the hybrid sends
to the kernel). Every launch is checked against the plain version first.
Prints the card line, one line per row, and writes every number as JSON to
``--out``. The values of ``kernels.tuning.TUNE_TILES`` and
``RESIDENT_NB_CEILING`` come from this sweep (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _batches(np, n: int, b: int = 4096):
    from chip_smoke import _queries

    rng = np.random.default_rng(0)
    x = rng.random(n, dtype=np.float32)
    a = rng.integers(0, n, b)
    c = rng.integers(0, n, b)
    uniform = (np.minimum(a, c).astype(np.int32), np.maximum(a, c).astype(np.int32))
    return x, {"uniform": uniform, "short": _queries(np.random.default_rng(1), n, b)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/tune_sweep.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tune_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import FLUSH_BYTES, _card_line, kernel_times

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_query import fused_query, fused_query_plain

    t_start = time.perf_counter()
    card = _card_line()
    print(f"[card] {card}")
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    out = {"card": card, "tiles": [], "fetch": []}

    def rows(n, fetches, tiles, table):
        x, batches = _batches(np, n)
        s = ops.build(x, 128, device=dev)
        args0 = (s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx)
        tables = dict(st_val=s.st_val, st_gidx=s.st_gidx)
        for bname, (l, r) in batches.items():
            lt = torch.from_numpy(l).to(dev)
            rt = torch.from_numpy(r).to(dev)
            want = fused_query_plain(*args0, lt, rt, **tables, fetch="dma")
            for fetch in fetches:
                for tile in tiles:
                    call = lambda: fused_query(*args0, lt, rt, **tables, fetch=fetch, tile=tile)
                    got = call()
                    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                        raise SystemExit(f"tune_sweep: fused_query {fetch} tile={tile} n={n} != plain")
                    t = kernel_times(torch, call, "fused_query_kernel", flush)
                    row = dict(n=n, nb=s.x_blocks.shape[0], batch=bname, fetch=fetch, tile=tile,
                               ms=t["ms"], cold_ms=t["cold_ms"], call_ms=t["call_ms"])
                    out[table].append(row)
                    print(f"[{table}] " + json.dumps(row))
        del s, args0, tables

    for n in (1 << 20, 1 << 26):
        rows(n, ("resident", "dma"), range(1, 33), "tiles")
    for lg in range(3, 20):
        rows((1 << lg) * 128, ("resident", "dma"), (8,), "fetch")

    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"[wall] tune_sweep.py took {time.perf_counter() - t_start:.1f} s; rows in {args.out}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
