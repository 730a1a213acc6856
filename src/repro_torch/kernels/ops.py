"""Public wrappers of the kernelized engine: ``build`` and ``query``.

``build``/``query`` mirror ``repro_torch.core.block_rmq`` but route the hot
path through the kernels: ``build`` takes per-block minima with
``block_min`` and returns a ``FusedRMQ`` (the ``BlockRMQ`` fields plus the
value-augmented tables of the dma fetch strategy, precomputed once);
``query`` answers a batch with one ``fused_query`` launch, its geometry from
a ``tuning.KernelConfig``. Port of ``repro/kernels/ops.py`` (unpacked,
fused path).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._device import resolve
from repro_torch.core import sparse_table
from repro_torch.core.block_rmq import pad_blocks

from .block_min import block_min
from .fused_query import fused_query, interior_tables
from .tuning import KernelConfig

__all__ = ["FusedRMQ", "build", "query", "block_min", "fused_query"]


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
    ``tile``/``fetch`` override single knobs. ``fused=False`` (the two-pass
    path over ``rmq_partials``) is not ported yet.
    """
    if not fused:
        raise NotImplementedError(
            "ops.query(fused=False) needs the rmq_partials kernel, not ported yet "
            "(ROADMAP.md, queue 2 item 6)"
        )
    if config is None:
        config = KernelConfig()
    if tile is None:
        tile = config.tile
    if fetch is None:
        fetch = config.fetch
    return fused_query(
        s.x_blocks, s.bmin_val, s.bmin_gidx, s.st.idx, l, r,
        st_val=getattr(s, "st_val", None),
        st_gidx=getattr(s, "st_gidx", None),
        tile=tile, fetch=fetch,
    )
