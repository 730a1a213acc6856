"""The catalogue: ``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is a file of its own under ``bench/``:

- ``configs/<config>.json``: the deployment, with its engine, its data
  generator, its sizes and the guarantees it states;
- ``traffic/<traffic>.json``: the parameters of the query mix, which
  ``queries`` reads, and the name of the loop that offers it;
- ``data/<data>.py``: ``make(config, seed, device)``, the array;
- ``loops/<loop>.py``: ``drive(...)``, how batches are offered;
- ``metrics/<metric>.py``: ``read(ctx)``, one reader per metric, end to end
  or per layer, which returns None where it finds nothing to read. A reader
  that some runs leave with nothing to read says which in ``NEEDS``: each
  condition of ``CONDITIONS`` it needs, with a one-line reason.

A new cell, traffic mix, data set or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes for it.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

__all__ = [
    "BENCH",
    "CONDITIONS",
    "ROOT",
    "Cell",
    "NAME_RE",
    "UNIT_RE",
    "cell",
    "data_generator",
    "load_benchmark",
    "load_file_module",
    "loop",
    "needs",
    "reader",
    "seed_for",
]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# The character rules of names and units.
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")

# What a reader may need that a run can lack: a CUDA device; in the traced
# slice, a query that dispatch routed short, one routed long, a batch that
# held both, a launch of one of the port's CUDA query kernels.
CONDITIONS = ("card", "short", "long", "mixed", "kernel")


class Cell(NamedTuple):
    """One workload of ``BENCHMARK.json`` with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _json(kind: str, name: str) -> dict:
    if not NAME_RE.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} breaks the name rules")
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)} for {name!r}")
    return json.loads(path.read_text())


def _reports(metric: dict, cell_name: str, reported_e2e: set) -> bool:
    """A metric with ``workloads`` is reported in those cells. One without
    is reported in every cell, a per-layer one in every cell that reports
    the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported_e2e


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files loaded."""
    bench = load_benchmark() if bench is None else bench
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        have = sorted(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {have}")
    w = entries[0]
    confs = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not confs:
        raise KeyError(f"workload {name!r} names config {w['config']!r}, which is not listed")
    config = json.loads((ROOT / confs[0]["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, _json("traffic", w["traffic"]), e2e, per_layer)


def load_file_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name`` (file names here
    may hold dots, which ``import`` cannot take)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(kind: str, name: str):
    if not NAME_RE.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} breaks the name rules")
    return load_file_module(BENCH / kind / f"{name}.py", f"bench_{kind}_{name.replace('.', '_')}")


def reader(metric: str):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def needs(metric: str) -> dict:
    """``NEEDS`` of ``metrics/<metric>.py``: each condition without which
    the reader reads None, with the reason; {} for a reader that reads in
    every run."""
    got = dict(getattr(_module("metrics", metric), "NEEDS", {}))
    unknown = sorted(set(got) - set(CONDITIONS))
    if unknown:
        raise ValueError(f"metric {metric!r} needs {unknown}, which are not among {CONDITIONS}")
    return got


def data_generator(name: str):
    """``make(config, seed, device)`` of ``data/<name>.py``."""
    return _module("data", name).make


def loop(name: str):
    """The module ``loops/<name>.py``."""
    return _module("loops", name)


def seed_for(seed: int, salt: str) -> int:
    """A 63-bit seed for one use (``salt``) of the run's ``--seed``: any
    whole number, negative or past 64 bits too, maps to a stream of its own."""
    digest = hashlib.sha256(f"{int(seed)}/{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
