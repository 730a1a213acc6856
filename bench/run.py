"""Run one cell of ``BENCHMARK.json`` on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit. Everything else goes to
standard error, whose last lines are the same checks.

Exits 2, printing no result, without CUDA or with fewer cards than the cell
asks for (it never falls back to the CPU), or where the checkout lacks the
program (``src/repro_torch``); exits 3, printing no result, if JAX or the
JAX package was loaded by the time the window closed. The first run of a
checkout builds the port's kernels into ``build/kernels/`` in the checkout,
later runs load them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here, before torch loads

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that may not be loaded: JAX and the JAX package
# (compared whole: the port, ``repro_torch``, begins with ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit(index: int):
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench import spec

    try:
        cell = spec.cell(args.workload)
    except (FileNotFoundError, KeyError, ValueError) as e:
        _err(f"[bench] {e}")
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        _err(f"[bench] no program at {src / 'repro_torch'}: run from a checkout of the repository")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _err(f"[bench] {cell.name} needs {cell.chips} CUDA device(s), found {have}; no CPU fallback")
        return 2
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    from bench import harness

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        _err(f"[bench] the run loaded {bad}: no result")
        return 3
    result["device"]["power_limit"] = power_limit(0)
    _err(f"[bench] {result['device']['kind']}, power limit {result['device']['power_limit']}")
    for name, c in result["checks"].items():
        _err(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not bench/: its modules are bench.*
    sys.exit(main())
