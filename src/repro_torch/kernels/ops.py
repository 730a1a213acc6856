"""Public wrappers of the kernelized engine: ``build`` and ``query``.

``build``/``query`` mirror ``repro_torch.core.block_rmq`` but route the hot
path through the kernels: ``build`` takes per-block minima with
``block_min`` and returns a ``FusedRMQ`` (the ``BlockRMQ`` fields plus the
value-augmented tables of the dma fetch strategy, precomputed once);
``query`` answers a batch with one ``fused_query`` launch, its geometry from
a ``tuning.KernelConfig``; ``query(fused=False)`` is the two-pass A/B path
(the ``rmq_partials`` kernel, then the interior and merge in PyTorch).
``build_packed``/``query_packed`` serve the packed word structures through
``fused_query_packed``, ``sparse_query`` a doubling table (the hybrid
engine's long path) through its kernel, and ``lane_query`` the lane engine
through ``lane_partials``. Port of ``repro/kernels/ops.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import as_index, resolve
from repro_torch.core import block_rmq, lane_rmq, sparse_table
from repro_torch.core.block_rmq import maxval, pad_blocks

from .block_min import block_min
from .fused_query import (
    decompose,
    fused_query,
    fused_query_packed,
    interior_tables,
    merge_interior,
)
from .lane_query import lane_partials
from .rmq_query import rmq_partials
from .sparse_query import sparse_query
from .tuning import DEFAULT_TILE, KernelConfig

__all__ = [
    "FusedRMQ",
    "PackedFusedRMQ",
    "build",
    "build_packed",
    "query",
    "query_packed",
    "sparse_query",
    "block_min",
    "fused_query",
    "fused_query_packed",
    "rmq_partials",
    "lane_query",
    "lane_partials",
]


class FusedRMQ(NamedTuple):
    """Kernel state: ``BlockRMQ``'s fields + the dma-strategy tables."""

    x_blocks: torch.Tensor  # (nb, bs)
    bmin_val: torch.Tensor  # (nb,)
    bmin_gidx: torch.Tensor  # (nb,) int32
    st: sparse_table.SparseTable  # doubling table over bmin_val
    st_val: torch.Tensor  # (K, nb): bmin_val[st.idx] (dma fetch strategy)
    st_gidx: torch.Tensor  # (K, nb) int32: bmin_gidx[st.idx]


def build(x, block_size: int, *, device=None) -> FusedRMQ:
    """Kernelized build on ``device``: ``block_min`` per-block minima + doubling tables."""
    x = torch.as_tensor(x, device=resolve(device))
    xb = pad_blocks(x, block_size)
    nb = xb.shape[0]
    bmin_val, lidx = block_min(xb)
    bmin_gidx = torch.arange(nb, dtype=torch.int32, device=x.device) * block_size + lidx
    st = sparse_table.build(bmin_val)
    st_val, st_gidx = interior_tables(bmin_val, bmin_gidx, st.idx)
    return FusedRMQ(
        x_blocks=xb,
        bmin_val=bmin_val,
        bmin_gidx=bmin_gidx,
        st=st,
        st_val=st_val,
        st_gidx=st_gidx,
    )


def _geometry(config, tile, fetch):
    if config is None:
        config = KernelConfig()
    return (config.tile if tile is None else tile), (config.fetch if fetch is None else fetch)


class PackedFusedRMQ(NamedTuple):
    """Packed kernel state: single-plane tables (``core.packing``).

    ``blocks`` holds packed words (exact layouts) or raw values (quantized);
    ``stw`` is the packed doubling table over block minima; ``bmin_val`` is
    the quantized layout's exact-fallback plane (None otherwise). The
    ``PackSpec`` rides beside the state, not in it.
    """

    blocks: torch.Tensor  # (nb, bs) packed words | raw values (quantized)
    stw: torch.Tensor  # (K, nb) packed doubling table
    bmin_val: torch.Tensor | None = None  # (nb,) exact minima, quantized only


def build_packed(x, block_size: int, *, spec=None, layout: str = "auto", device=None):
    """Packed kernel build on ``device``. Returns ``(PackedFusedRMQ, spec)``.

    The structure is ``core.block_rmq.build_packed``'s (torch ops; no kernel
    runs in the packed build, as in the reference); the quantized layout
    also keeps its exact per-block minima for the kernel's fallback hop.
    """
    s, spec = block_rmq.build_packed(x, block_size, spec=spec, layout=layout, device=device)
    bmin_val = None
    if spec.layout == "quantized":
        bmin_val = block_rmq.signed_min(s.blocks)  # blocks are raw (maxval-padded)
    return PackedFusedRMQ(blocks=s.blocks, stw=s.stw, bmin_val=bmin_val), spec


def query_packed(s: PackedFusedRMQ, spec, l, r, *, config=None, tile=None, fetch=None):
    """Packed kernel batched query -> (leftmost argmin idx int32, value); the
    launch geometry from ``config`` (the structure's ``spec`` decides the
    layout)."""
    tile, fetch = _geometry(config, tile, fetch)
    return fused_query_packed(
        s.blocks, s.stw, l, r, spec=spec, bmin_val=s.bmin_val, tile=tile, fetch=fetch
    )


def query(
    s,
    l,
    r,
    *,
    config: KernelConfig | None = None,
    tile: int | None = None,
    fetch: str | None = None,
    fused: bool = True,
):
    """Kernelized batched query. Returns (leftmost argmin idx int32, value).

    ``s`` is a ``FusedRMQ`` (or a bare ``BlockRMQ``, for which the dma
    strategy derives its tables on the fly). ``config`` carries the launch
    geometry (its ``block_size`` is ignored: the structure has one);
    ``tile``/``fetch`` override single knobs. ``fused=False`` is the two-pass
    path: the ``rmq_partials`` kernel, then the sparse-table interior and
    the merge in PyTorch (kept for A/B comparison).
    """
    tile, fetch = _geometry(config, tile, fetch)
    if fused:
        return fused_query(
            s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, l, r,
            st_val=getattr(s, "st_val", None),
            st_gidx=getattr(s, "st_gidx", None),
            tile=tile, fetch=fetch,
        )
    nb, bs = s.x_blocks.shape
    dev = s.x_blocks.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    bl, br, ls, le, re, hasint, _, ilo, _ = decompose(l, r, nb, bs)
    pv, pi = rmq_partials(s.x_blocks, bl, br, ls, le, re, tile=tile)
    ihi = torch.maximum(torch.clamp(br - 1, 0, nb - 1), ilo)
    bi = sparse_table.query(s.st, ilo, ihi)
    iv = torch.where(hasint, s.bmin_val[bi], maxval(s.x_blocks.dtype))
    # The partials straddle the interior in index order: prefer one only when
    # strictly smaller or when it is the left partial (pi < int_start).
    return merge_interior(pv, pi, iv, s.bmin_gidx[bi], (bl + 1) * bs)


def lane_query(s: lane_rmq.LaneRMQ, l, r, *, tile: int = DEFAULT_TILE):
    """Kernelized lane-RMQ query (mirrors ``core.lane_rmq.query``): the
    ``lane_partials`` kernel answers the same-block case and the straddle
    candidates; the O(1) interior and the merge stay in PyTorch."""
    nsub = s.xs.shape[0]
    dev = s.xs.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    sl = l // lane_rmq.LANE
    sr = r // lane_rmq.LANE
    llo = l - sl * lane_rmq.LANE
    rlo = r - sr * lane_rmq.LANE
    pv, pi = lane_partials(
        s.xs, s.suff_val, s.suff_idx, s.pref_val, s.pref_idx, sl, sr, llo, rlo, tile=tile
    )
    ilo = torch.clamp(sl + 1, 0, nsub - 1)
    ihi = torch.maximum(torch.clamp(sr - 1, 0, nsub - 1), ilo)
    bi = sparse_table.query(s.st, ilo, ihi)
    iv = torch.where((sr - sl) >= 2, s.st.x[bi], maxval(s.xs.dtype))
    return merge_interior(pv, pi, iv, s.sub_gidx[bi], (sl + 1) * lane_rmq.LANE)
