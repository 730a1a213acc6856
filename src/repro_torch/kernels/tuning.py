"""Persistent autotuner for the fused query kernel's launch geometry.

The kernel has three static knobs: ``tile`` (queries, one warp each, per
thread block: 1 to 32), ``fetch`` (the interior's tables: ``resident``, two
hops through the block-minimum planes, or ``dma``, one hop into the
value-augmented tables, see ``fused_query.py``) and ``block_size``. The
right setting is a property of (problem size, batch, machine), not of the
code. This module sweeps the config product, times each candidate with the
measurement seam ``hybrid.calibrate`` uses (``hybrid._measure``,
monkeypatchable in tests), and persists winners in the calibration JSON
cache (``core.calib_cache``) under a ``kernel/`` key namespace:

    kernel/n=65536/batch=4096/backend=cuda/ndev=1
        -> {"tile": 8, "fetch": "dma", "block_size": 128, "layout": "unpacked"}

Policy resolution (``get_config``):

* ``None``      — the deterministic default config. Never touches the cache
  or any machine state.
* ``"cached"``  — read-only cache lookup, default fallback on miss. Never
  measures.
* ``"tuned"``   — cache lookup; sweeps and persists on a miss, so repeated
  builds of one configuration time the product once per machine.

Port of ``repro/kernels/tuning.py``. The names are the reference's; the
values of ``TUNE_TILES`` and ``RESIDENT_NB_CEILING`` were measured on the
H100 (``tools/tune_sweep.py``; the numbers are in PERF.md), not carried over
from the TPU, where they were VMEM facts.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

__all__ = [
    "DEFAULT_TILE",
    "DEFAULT_TUNE_BATCH",
    "FETCH_STRATEGIES",
    "KernelConfig",
    "MAX_TILE",
    "RESIDENT_NB_CEILING",
    "TUNE_BLOCK_SIZES",
    "TUNE_LAYOUTS",
    "TUNE_TILES",
    "autotune",
    "candidate_configs",
    "config_from_entry",
    "default_config",
    "get_config",
    "resolve_fetch",
    "sweep",
    "tuning_key",
]

# Queries answered per thread block (one warp each): 8 -> 256 threads.
DEFAULT_TILE = 8

# A thread block holds at most 1024 threads: 32 warps.
MAX_TILE = 32

# Table fetch strategies fused_query implements (module docstring there).
FETCH_STRATEGIES = ("resident", "dma")

# Above this many blocks "auto" switches from the two-hop resident tables to
# the one-hop value-augmented dma tables. On the H100 dma was 3-10% faster
# from nb = 2^6 to 2^19 and within 2% of resident below (PERF.md §6).
RESIDENT_NB_CEILING = 1 << 4

# Swept values. Small on purpose: each candidate costs timed queries, and
# the product is per (n, batch, backend, ndev) cache entry. The four tiles
# of 1..32 whose device time stayed nearest the best of every measured row
# on the H100 (PERF.md §6).
TUNE_TILES = (4, 8, 16, 32)
TUNE_BLOCK_SIZES = (128, 256)
DEFAULT_TUNE_BATCH = 4096

# The packed-structure layout axis. ``candidate_configs`` sweeps only
# "unpacked" unless the caller opts the axis in (``layouts=TUNE_LAYOUTS`` or
# a subset): packed64 has no fused engine, as in the reference; the quantized
# fallback hop reads its resident plane, so it has no dma strategy; and
# ``sweep`` skips packed32 where the sweep data's key span does not fit.
TUNE_LAYOUTS = ("unpacked", "packed32", "quantized", "packed64")


class KernelConfig(NamedTuple):
    """Static launch geometry for the fused query kernel.

    ``layout`` is the word layout a fused build takes when ``packed=`` does
    not pin one ("unpacked", "packed32" or "quantized"), as in the reference.
    """

    tile: int = DEFAULT_TILE
    fetch: str = "auto"  # "resident" | "dma" | "auto" (resolve by nb)
    block_size: int = 128
    layout: str = "unpacked"


def resolve_fetch(fetch: str, nb: int) -> str:
    """Concrete fetch strategy for ``nb`` blocks ("auto" -> by the ceiling)."""
    if fetch == "auto":
        return "dma" if nb > RESIDENT_NB_CEILING else "resident"
    if fetch not in FETCH_STRATEGIES:
        raise ValueError(f"unknown fetch strategy {fetch!r} (want {FETCH_STRATEGIES})")
    return fetch


def default_config(block_size: int = 128) -> KernelConfig:
    """The untuned config: machine-independent, deterministic."""
    return KernelConfig(tile=DEFAULT_TILE, fetch="auto", block_size=block_size)


def candidate_configs(n: int, block_size: int | None = None, *, layouts=None):
    """The swept config product for an ``n``-element array.

    ``block_size`` pins that knob (hybrid builds tune within their block
    size; fused builds sweep it). Resident candidates past the nb ceiling
    are excluded. The default config's resolution is always a member, so
    the tuned winner can never be slower than the default on the sweep's
    own measurements. ``layouts`` opts the packed-structure axis in;
    packed64 (no fused engine) and quantized-dma (no such body) candidates
    are never built.
    """
    sizes = (block_size,) if block_size is not None else TUNE_BLOCK_SIZES
    if layouts is None:
        layouts = ("unpacked",)
    out = []
    for bs, fetch, tile, lay in itertools.product(sizes, FETCH_STRATEGIES, TUNE_TILES, layouts):
        if fetch == "resident" and -(-n // bs) > RESIDENT_NB_CEILING:
            continue
        if lay == "packed64":
            continue  # no fused engine takes packed64
        if lay == "quantized" and fetch == "dma":
            continue  # fallback hop needs the resident exact-minima plane
        out.append(KernelConfig(tile=tile, fetch=fetch, block_size=bs, layout=lay))
    for bs in sizes:  # the resolved default, if the product missed it
        d = KernelConfig(DEFAULT_TILE, resolve_fetch("auto", -(-n // bs)), bs)
        if d not in out:
            out.append(d)
    return out


def tuning_key(
    n: int,
    batch: int = DEFAULT_TUNE_BATCH,
    *,
    backend: str | None = None,
    n_devices: int | None = None,
    layout: str | None = None,
) -> str:
    """Cache key for a tuned config: ``kernel/`` namespace + (n, batch,
    backend, ndev), disjoint from the threshold keys in the same file.
    ``backend``/``n_devices`` default from torch (``calib_cache.machine``).

    ``layout`` scopes a tuning slot to one packed layout; the default
    appends nothing. A sweep run *across* layouts stores under the default
    slot: the winning config's own ``layout`` field records what won.
    """
    from repro_torch.core import calib_cache

    backend, n_devices = calib_cache.machine(backend, n_devices)
    key = f"kernel/n={n}/batch={batch}/backend={backend}/ndev={n_devices}"
    if layout is not None and layout != "unpacked":
        key += f"/layout={layout}"
    return key


def config_from_entry(entry) -> KernelConfig | None:
    """KernelConfig from a cached JSON entry; None if malformed (treated as
    a miss: a cache must never turn into a crash). A tile above
    ``MAX_TILE`` is malformed: the kernel cannot launch it."""
    if not isinstance(entry, dict):
        return None
    try:
        cfg = KernelConfig(
            tile=int(entry["tile"]),
            fetch=str(entry["fetch"]),
            block_size=int(entry["block_size"]),
            # Pre-layout entries (and migrated v2 files) mean unpacked.
            layout=str(entry.get("layout", "unpacked")),
        )
    except (KeyError, TypeError, ValueError):
        return None
    if cfg.fetch not in FETCH_STRATEGIES + ("auto",):
        return None
    if not 1 <= cfg.tile <= MAX_TILE or cfg.block_size % 128 != 0:
        return None
    if cfg.layout not in TUNE_LAYOUTS:
        return None
    return cfg


def sweep(
    n: int,
    batch: int = DEFAULT_TUNE_BATCH,
    *,
    block_size: int | None = None,
    candidates=None,
    seed: int = 0,
    repeats: int = 3,
    device=None,
):
    """Time every candidate config on ``device``. Returns ``[(KernelConfig, seconds)]``.

    One mixed-length query batch (seeded, the reference's data) is timed
    through the fused kernel per candidate, via ``hybrid._measure`` (tests
    monkeypatch it to make sweeps deterministic and to assert a warm cache
    performs none). Builds are shared across the candidates of a (block
    size, layout). Packed candidates the sweep data cannot encode (a
    packed32 key span that does not fit) are skipped, not errored.
    """
    import numpy as np

    from repro_torch._device import as_index, resolve
    from repro_torch.core import hybrid

    from . import ops

    dev = resolve(device)
    if candidates is None:
        candidates = candidate_configs(n, block_size)
    rng = np.random.default_rng(seed)
    x = rng.random(n, dtype=np.float32)
    a = rng.integers(0, n, batch)
    b = rng.integers(0, n, batch)
    lj = as_index(np.minimum(a, b), dev)
    rj = as_index(np.maximum(a, b), dev)

    results = []
    built = {}
    for cfg in candidates:
        bkey = (cfg.block_size, cfg.layout)
        if bkey not in built:
            if cfg.layout == "unpacked":
                built[bkey] = (ops.build(x, cfg.block_size, device=dev), None)
            else:
                try:
                    built[bkey] = ops.build_packed(x, cfg.block_size, layout=cfg.layout, device=dev)
                except ValueError:
                    built[bkey] = None  # data can't express this layout
        if built[bkey] is None:
            continue
        s, spec = built[bkey]

        if cfg.layout == "unpacked":

            def fn(l, r, s=s, cfg=cfg):
                return ops.query(s, l, r, config=cfg)

        else:

            def fn(l, r, s=s, spec=spec, cfg=cfg):
                return ops.query_packed(s, spec, l, r, config=cfg)

        kind = f"kernel/tile={cfg.tile}/fetch={cfg.fetch}/bs={cfg.block_size}"
        if cfg.layout != "unpacked":
            kind += f"/layout={cfg.layout}"
        results.append((cfg, hybrid._measure(kind, fn, lj, rj, repeats)))
    return results


def autotune(
    n: int,
    batch: int = DEFAULT_TUNE_BATCH,
    *,
    block_size: int | None = None,
    candidates=None,
    seed: int = 0,
    repeats: int = 3,
    device=None,
) -> KernelConfig:
    """Sweep the config product and return the fastest candidate.

    Ties break toward the earliest candidate in the (deterministic) product
    order, so a fake-measure test pins the winner exactly.
    """
    results = sweep(
        n,
        batch,
        block_size=block_size,
        candidates=candidates,
        seed=seed,
        repeats=repeats,
        device=device,
    )
    best_cfg, _ = min(results, key=lambda cv: cv[1])
    return best_cfg


def get_config(
    n: int,
    batch: int = DEFAULT_TUNE_BATCH,
    *,
    policy: str | None = None,
    block_size: int | None = None,
    backend: str | None = None,
    n_devices: int | None = None,
    path=None,
    device=None,
    **tune_kw,
) -> KernelConfig:
    """Resolve the kernel config for an (n, batch) point under ``policy``.

    See the module docstring for the three policies. ``block_size`` pins the
    sweep (and the default's block size) when the caller's structure is
    already committed to one. ``device`` is where a ``"tuned"`` miss sweeps
    (the builds pass its type as ``backend``).
    """
    if policy is None:
        return default_config(block_size if block_size is not None else 128)
    if policy not in ("cached", "tuned"):
        raise ValueError(f"unknown kernel-config policy {policy!r}")

    from repro_torch.core import calib_cache

    key = tuning_key(n, batch, backend=backend, n_devices=n_devices)
    cfg = config_from_entry(calib_cache.load_entry(key, path))
    if cfg is not None:
        return cfg
    if policy == "cached":
        return default_config(block_size if block_size is not None else 128)
    cfg = autotune(n, batch, block_size=block_size, device=device, **tune_kw)
    calib_cache.store_entry(key, dict(cfg._asdict()), path)
    return cfg
