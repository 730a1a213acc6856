"""Persistent measurement cache: calibration thresholds + tuned kernel configs.

Copy of ``repro/core/calib_cache.py`` for the port (framework-free but for
the defaults of ``cache_key``: the backend and device count come from torch,
``"cuda"``/``torch.cuda.device_count()`` or ``"cpu"``/1). The port keeps its
own file: ``RMQ_TORCH_CALIB_CACHE`` and
``~/.cache/rtxrmq-torch/calibration.json``. The reference and the port must
never read each other's measurements: a JAX ``cpu`` entry and a torch
``cpu`` entry would share a key. Everything else is the reference's: the
version, the v2 migration, the key schema, atomic writes, corrupt files
read as empty.

``hybrid.calibrate`` measures the blocked-vs-sparse-table crossover by timing
both constituent paths — seconds of wall-clock per (n, block_size) point.
Re-measuring at every build is waste: the crossover is a property of the
machine, not of the process. This module persists measured thresholds in a
small JSON file keyed by ``(n, block_size, backend, n_devices)`` so builds
hit the cache and only a first-ever configuration pays the measurement.

File format (atomic rename on write):

    {"version": 2, "entries": {"n=1048576/bs=128/backend=tpu/ndev=8": 1024,
                               "kernel/n=65536/batch=4096/backend=tpu/ndev=8":
                                   {"tile": 8, "fetch": "dma", "block_size": 128}}}

Key v2: sharded measurements additionally carry the distribution mode and
mesh shape (``.../ndev=8/mode=shard_2d/mesh=2x4``) so modes no longer share
one threshold slot per mesh size.

Cache v2 (file ``version`` 2): entries are arbitrary JSON values, not just
int thresholds. The megakernel autotuner (``kernels.tuning``) stores
winning ``(tile, fetch, block_size)`` configs as dicts under a ``kernel/``
key-namespace prefix, sharing the same file, atomic-write discipline, and
staleness rules as thresholds. ``load``/``store`` stay int-typed for
threshold callers; ``load_entry``/``store_entry`` are the generic seam.
The version bump marks every v1 entry stale (thresholds re-measure once).

Cache v3: the packed-structure ``layout`` joins the key schema. A
measurement on packed words is a different measurement (one plane moved,
one collective, different fetch volume), so ``cache_key``/the autotuner's
``tuning_key`` append ``/layout=<name>`` — but only for non-default
layouts, keeping every existing unpacked key byte-identical. v2 files are
*migrated*, not dropped: every v2 entry was measured on unpacked
structures, which is exactly what the unchanged unpacked keys mean, so
``_read`` keeps them (annotating ``kernel/`` config dicts with
``layout: "unpacked"``) and the next store persists the file as v3.

A pre-v2 version mismatch marks every entry stale: ``load`` misses, and
the next ``store`` drops the old entries wholesale. Corrupt or unreadable
files are treated as empty — a cache must never turn into a crash.

Path resolution: explicit ``path`` argument > ``RMQ_TORCH_CALIB_CACHE`` env
var > ``~/.cache/rtxrmq-torch/calibration.json``.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import torch

__all__ = [
    "CACHE_VERSION",
    "ENV_VAR",
    "cache_key",
    "default_path",
    "get_threshold",
    "load",
    "load_entry",
    "machine",
    "store",
    "store_entry",
]

CACHE_VERSION = 3
ENV_VAR = "RMQ_TORCH_CALIB_CACHE"

# v2 -> v3 is key-schema growth, not a measurement change: every v2 entry
# maps 1:1 onto a v3 unpacked-layout entry.
_MIGRATABLE_VERSIONS = (2,)


def default_path() -> Path:
    env = os.environ.get(ENV_VAR)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "rtxrmq-torch" / "calibration.json"


def machine(backend: str | None = None, n_devices: int | None = None):
    """``(backend, n_devices)`` of a key, each defaulted from torch: the
    ``cuda`` backend with its device count where CUDA is available, else
    ``cpu`` with 1. A caller that builds on a known device passes its type."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if n_devices is None:
        n_devices = torch.cuda.device_count() if backend == "cuda" else 1
    return backend, n_devices


def cache_key(
    n: int,
    block_size: int,
    *,
    backend: str | None = None,
    n_devices: int | None = None,
    mode: str | None = None,
    mesh_shape=None,
    layout: str | None = None,
) -> str:
    """The cache key: array size, block size, backend, and device count.

    Key v2 (sharded builds): a sharded measurement varies with the
    distribution mode AND the mesh factoring (a 2x4 struct x batch grid
    times different collectives than an 8x1), so passing ``mode`` (with the
    mesh shape) extends the key — without it, whichever mode calibrated a
    configuration first owned the threshold for every mode on that mesh
    size (the ROADMAP bug). Single-host builds pass neither and keep the
    v1 key, so their existing entries stay valid.

    Key v3 (packed structures): a packed build's crossover is measured on
    word planes, so ``layout`` extends the key. The default (None or
    ``"unpacked"``) appends nothing — migrated v2 entries keep matching.
    """
    backend, n_devices = machine(backend, n_devices)
    key = f"n={n}/bs={block_size}/backend={backend}/ndev={n_devices}"
    if mode is not None:
        shape = "x".join(str(int(s)) for s in mesh_shape) if mesh_shape else "?"
        key += f"/mode={mode}/mesh={shape}"
    if layout is not None and layout != "unpacked":
        key += f"/layout={layout}"
    return key


def _migrate(version, entries: dict) -> dict:
    """Lift a prior-version entries dict into the current schema.

    v2 -> v3: every v2 measurement was taken on unpacked structures and v3
    left unpacked keys unchanged, so the keys carry over verbatim; only the
    ``kernel/`` config dicts gain an explicit ``layout: "unpacked"`` stamp
    (threshold ints need none — their key IS the layout marker).
    """
    out = {}
    for key, value in entries.items():
        if key.startswith("kernel/") and isinstance(value, dict):
            value = {**value, "layout": value.get("layout", "unpacked")}
        out[key] = value
    return out


def _read(path: Path) -> dict:
    """Entries dict, or {} on missing / corrupt / stale-version files.

    Migratable prior versions (v2) are lifted in-memory; the file itself is
    rewritten as the current version on the next ``store``.
    """
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict):
        return {}
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return {}
    version = data.get("version")
    if version == CACHE_VERSION:
        return entries
    if version in _MIGRATABLE_VERSIONS:
        return _migrate(version, entries)
    return {}  # stale format: every entry is a miss


def load_entry(key: str, path: str | Path | None = None):
    """Cached JSON value for ``key``, or None on miss/stale/corrupt."""
    entries = _read(Path(path) if path is not None else default_path())
    return entries.get(key)


def store_entry(key: str, value, path: str | Path | None = None) -> None:
    """Persist ``key -> value`` (any JSON value), keeping same-version entries."""
    p = Path(path) if path is not None else default_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    entries = _read(p)  # drops stale-version/corrupt content wholesale
    entries[key] = value
    fd, tmp = tempfile.mkstemp(dir=p.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": entries}, f, indent=2)
        os.replace(tmp, p)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load(key: str, path: str | Path | None = None) -> int | None:
    """Cached threshold for ``key``, or None on miss/stale/corrupt."""
    val = load_entry(key, path)
    return int(val) if val is not None else None


def store(key: str, threshold: int, path: str | Path | None = None) -> None:
    """Persist ``key -> threshold``, keeping other same-version entries."""
    store_entry(key, int(threshold), path)


def get_threshold(
    n: int,
    block_size: int,
    *,
    backend: str | None = None,
    n_devices: int | None = None,
    mode: str | None = None,
    mesh_shape=None,
    layout: str | None = None,
    path: str | Path | None = None,
    **calibrate_kw,
) -> int:
    """Cached crossover threshold; measures via ``hybrid.calibrate`` on miss.

    ``mode``/``mesh_shape`` extend the key for sharded measurements (key v2)
    and ``mode`` is forwarded to the calibration itself; single-host callers
    omit both and keep hitting their v1 entries. ``layout`` (key v3) does
    the same for packed builds: it extends the key and makes the miss-path
    measurement time the packed constituents.
    """
    key = cache_key(
        n,
        block_size,
        backend=backend,
        n_devices=n_devices,
        mode=mode,
        mesh_shape=mesh_shape,
        layout=layout,
    )
    hit = load(key, path)
    if hit is not None:
        return hit
    from . import hybrid  # deferred: hybrid also consumes this module

    if mode is not None:
        calibrate_kw["mode"] = mode
    if layout is not None and layout != "unpacked":
        calibrate_kw["layout"] = layout
    thr = hybrid.calibrate(n, block_size=block_size, **calibrate_kw)
    store(key, thr, path)
    return thr
