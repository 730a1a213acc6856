"""Launch geometry of the fused query kernel: constants and ``KernelConfig``.

Port of the configuration half of ``repro/kernels/tuning.py`` (:54-102).
The constants keep their names for parity with the reference; their values
are the reference's TPU values, which were VMEM facts there. On the H100
``tile`` is the number of queries (warps) per thread block and
``RESIDENT_NB_CEILING`` the block count above which ``fetch="auto"`` picks
the one-hop ``dma`` tables; both are to be re-measured on the card (the
sweep, ``autotune`` and the cache policies are a later slice, see
ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = [
    "DEFAULT_TILE",
    "FETCH_STRATEGIES",
    "KernelConfig",
    "RESIDENT_NB_CEILING",
    "default_config",
    "resolve_fetch",
]

# Queries answered per thread block (one warp each): 8 -> 256 threads.
DEFAULT_TILE = 8

# Table fetch strategies fused_query implements (module docstring there).
FETCH_STRATEGIES = ("resident", "dma")

# Above this many blocks "auto" switches from the two-hop resident tables to
# the one-hop value-augmented dma tables.
RESIDENT_NB_CEILING = 1 << 13


class KernelConfig(NamedTuple):
    """Static launch geometry for the fused query kernel.

    ``layout`` keeps the reference's field for parity; only "unpacked"
    exists in the port so far.
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
