"""The readings that a cell's limits are set from, in one process on the card.

    python3 bench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 --seconds 2

Runs the cell once per seed with the program (the lower reading: what
sound runs give) and once per control seed with the plain reference in the
next precision below the configuration's in the program's place (the
upper reading: what the check has to fail). Each run is a whole run of the
harness at the cell's own sizes, with a short window. One JSON line per
run on standard output, then a summary. The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(p) for p in (ROOT, ROOT / "src") if str(p) not in sys.path]
    import torch

    from bench import harness, reference, spec

    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    readings = {"program": [], "control": []}
    runs = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for side, seed in runs:
        engine = reference.ControlEngine() if side == "control" else None
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", engine=engine)
        line = {
            "side": side,
            "seed": seed,
            "correct": res["correct"],
            "attempted": res["attempted"],
            "failed": res["failed"],
            "checks": res["checks"],
            "seconds": time.perf_counter() - t0,
        }
        print(json.dumps(line), flush=True)
        readings[side].append({k: c["value"] for k, c in res["checks"].items()})
        del res
        gc.collect()
        torch.cuda.empty_cache()
    summary = {
        side: {k: [r[k] for r in rs] for k in (rs[0] if rs else {})} for side, rs in readings.items()
    }
    print(json.dumps({"workload": cell.name, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not bench/: its modules are bench.*
    sys.exit(main())
