"""Fused blocked-RMQ query: wrapper, value-augmented tables, plain version.

``fused_query`` answers a whole query batch in one launch of the CUDA kernel
of ``csrc/fused_query.cu`` for CUDA tensors, and runs ``fused_query_plain``
for CPU tensors. The kernel replaces the Pallas TPU megakernel
``fused_query`` (src/repro/kernels/fused_query.py), both fetch strategies:

  * ``"resident"`` — the interior candidate takes two hops: the doubling
    table ``st_idx[k, .]`` gives block ids, ``bmin_val``/``bmin_gidx`` give
    their values and global indices. On the card these planes are read from
    global memory / L2 (staging them in shared memory is later work).
  * ``"dma"`` — the doubling table is value-augmented at build time
    (:func:`interior_tables`), so the interior needs the two cells at
    ``(k, ilo)`` and ``(k, bpos)`` only: one hop.

``fetch="auto"`` picks by ``tuning.RESIDENT_NB_CEILING``. Both strategies
return the same bits: the lo cell starts at or before the hi cell, so
preferring lo on value ties is the leftmost rule ``_pick_left`` applies.
The source note of the kernel gives its bound and its design.
"""

from __future__ import annotations

import logging
import threading

import torch

from repro_torch._device import as_index
from repro_torch.core.block_rmq import maxval
from repro_torch.core.sparse_table import exact_log2

from . import _build
from .tuning import DEFAULT_TILE, resolve_fetch

__all__ = ["fused_query", "fused_query_plain", "interior_tables", "DEFAULT_TILE"]

_logger = logging.getLogger(__name__)
_DTYPES = {torch.float32: "f32", torch.int32: "i32"}
_count_lock = threading.Lock()
_warned_materialize = False


def interior_tables(bmin_val: torch.Tensor, bmin_gidx: torch.Tensor, st_idx: torch.Tensor):
    """Value-augmented doubling tables for the dma fetch strategy.

    ``st_val[k, p] = bmin_val[st_idx[k, p]]`` and ``st_gidx`` likewise:
    O(K * nb) gathers, computed once at build.
    """
    return bmin_val[st_idx], bmin_gidx[st_idx]


def fused_query_plain(
    x_blocks, bmin_val, bmin_gidx, st_idx, l, r, *, st_val=None, st_gidx=None, fetch="resident"
):
    """The reference kernel's arithmetic in PyTorch, the whole batch at once.

    The scalar decomposition of ``fused_query.py:224-237`` (with the
    reference ``exact_log2``), the masked-iota partials, the interior cells
    of ``fetch`` and the merges of ``fused_query.py:157-169``. ``l``/``r``
    are int32 tensors on ``x_blocks``'s device.
    """
    nb, bs = x_blocks.shape
    big = maxval(x_blocks.dtype)
    bl = l // bs
    br = r // bs
    ls = l - bl * bs
    re = r - br * bs
    le = torch.where(bl == br, re, bs - 1)
    hasint = (br - bl) >= 2
    ilo = torch.clamp(bl + 1, 0, nb - 1)
    ihi = torch.maximum(torch.clamp(br - 1, 0, nb - 1), ilo)
    k = exact_log2(ihi - ilo + 1)
    bpos = ihi - (1 << k) + 1

    lanes = torch.arange(bs, dtype=torch.int32, device=x_blocks.device)[None, :]
    ml = torch.where((lanes >= ls[:, None]) & (lanes <= le[:, None]), x_blocks[bl], big)
    lv = ml.min(dim=1).values
    li = torch.where(ml == lv[:, None], lanes, bs).min(dim=1).values
    lg = bl * bs + li

    mr = torch.where(lanes <= re[:, None], x_blocks[br], big)
    rv = mr.min(dim=1).values
    rv = torch.where(br > bl, rv, big)
    ri = torch.where(mr == rv[:, None], lanes, bs).min(dim=1).values
    rg = br * bs + ri

    take_l = lv <= rv  # left candidate has smaller indices: leftmost ties
    pv = torch.where(take_l, lv, rv)
    pi = torch.where(take_l, lg, rg)

    if fetch == "resident":
        a = st_idx[k, ilo]
        b = st_idx[k, bpos]
        av, bv, ai, bi = bmin_val[a], bmin_val[b], bmin_gidx[a], bmin_gidx[b]
    else:
        av, bv = st_val[k, ilo], st_val[k, bpos]
        ai, bi = st_gidx[k, ilo], st_gidx[k, bpos]
    take_lo = av <= bv
    iv = torch.where(hasint, torch.where(take_lo, av, bv), big)
    ii = torch.where(take_lo, ai, bi)

    # Prefer the partial only when strictly smaller, or tied with an index
    # left of the interior block range.
    int_start = (bl + 1) * bs
    prefer_partial = (pv < iv) | ((pv == iv) & (pi < int_start))
    return torch.where(prefer_partial, pi, ii), torch.where(prefer_partial, pv, iv)


def _check_leaf(name, t, dtype, device, ndim):
    if t.dtype != dtype or t.device != device or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"fused_query: {name} must be a contiguous {ndim}-D {dtype} tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def fused_query(
    x_blocks: torch.Tensor,  # (nb, bs)
    bmin_val: torch.Tensor,  # (nb,)
    bmin_gidx: torch.Tensor,  # (nb,) int32
    st_idx: torch.Tensor,  # (K, nb) int32 doubling table over bmin_val
    l,  # (B,) query bounds (cast to int32 on x_blocks's device)
    r,
    *,
    st_val: torch.Tensor | None = None,  # (K, nb) value-augmented table (dma)
    st_gidx: torch.Tensor | None = None,  # (K, nb) int32 gidx-augmented table (dma)
    tile: int = DEFAULT_TILE,
    fetch: str = "auto",
    materialize_interior: bool | None = None,
):
    """End-to-end fused blocked RMQ. Returns (idx (B,) int32, value (B,)).

    One kernel launch per batch on the card, ``tile`` queries (warps) per
    thread block. A dma call without the augmented tables derives them on
    the fly, O(K * nb) gathers per call that a build precomputes once via
    :func:`interior_tables`: ``materialize_interior=True`` opts in silently,
    ``False`` raises instead, and the default ``None`` derives but warns
    once per process.
    """
    nb, bs = x_blocks.shape
    if x_blocks.dtype not in _DTYPES:
        raise TypeError(f"fused_query takes float32 or int32 values, got {x_blocks.dtype}")
    dev = x_blocks.device
    fetch = resolve_fetch(fetch, nb)
    l = as_index(l, dev)
    r = as_index(r, dev)
    if l.ndim != 1 or l.shape != r.shape:
        raise ValueError(f"l/r must be equal-shape 1-D, got {tuple(l.shape)} / {tuple(r.shape)}")
    if fetch == "dma" and (st_val is None or st_gidx is None):
        if materialize_interior is False:
            raise ValueError(
                "fetch='dma' without st_val/st_gidx while materialize_interior=False: "
                "the caller expected precomputed augmented tables (interior_tables)"
            )
        if materialize_interior is None:
            global _warned_materialize
            if not _warned_materialize:
                _warned_materialize = True
                _logger.warning(
                    "fused_query fetch='dma' is deriving its augmented interior tables "
                    "on the fly (O(K*nb) gathers per call). Precompute them at build "
                    "time (kernels.ops.build / interior_tables), or pass "
                    "materialize_interior=True to opt in silently."
                )
        st_val, st_gidx = interior_tables(bmin_val, bmin_gidx, st_idx)
    if dev.type == "cpu":
        return fused_query_plain(
            x_blocks, bmin_val, bmin_gidx, st_idx, l, r, st_val=st_val, st_gidx=st_gidx, fetch=fetch
        )
    if dev.type != "cuda":
        raise ValueError(f"fused_query runs on cuda or cpu tensors, got {dev}")
    if not 1 <= tile <= 32:
        raise ValueError(f"tile must be in [1, 32] warps per thread block, got {tile}")
    _check_leaf("x_blocks", x_blocks, x_blocks.dtype, dev, 2)
    if fetch == "resident":
        _check_leaf("bmin_val", bmin_val, x_blocks.dtype, dev, 1)
        _check_leaf("bmin_gidx", bmin_gidx, torch.int32, dev, 1)
        _check_leaf("st_idx", st_idx, torch.int32, dev, 2)
        if bmin_val.shape[0] != nb or bmin_gidx.shape[0] != nb or st_idx.shape[1] != nb:
            raise ValueError("fused_query: block-min planes and st_idx must have nb columns")
        ptrs = (bmin_val.data_ptr(), bmin_gidx.data_ptr(), st_idx.data_ptr(), None, None)
    else:
        _check_leaf("st_val", st_val, x_blocks.dtype, dev, 2)
        _check_leaf("st_gidx", st_gidx, torch.int32, dev, 2)
        if st_val.shape[1] != nb or st_gidx.shape != st_val.shape:
            raise ValueError("fused_query: st_val/st_gidx must be (K, nb) and alike")
        ptrs = (None, None, None, st_val.data_ptr(), st_gidx.data_ptr())
    l = l.contiguous()
    r = r.contiguous()
    b = l.shape[0]
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    val = torch.empty(b, dtype=x_blocks.dtype, device=dev)
    if b == 0:
        return idx, val
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        fn = getattr(lib, f"repro_fused_query_{_DTYPES[x_blocks.dtype]}")
        code = fn(
            x_blocks.data_ptr(), *ptrs, l.data_ptr(), r.data_ptr(), idx.data_ptr(), val.data_ptr(),
            b, nb, bs, int(fetch == "dma"), tile, stream,
        )
        _build.check(code, f"fused_query[{fetch}]")
    with _count_lock:
        fused_query.launches += 1
        fused_query.launches_by_fetch[fetch] += 1
    return idx, val


# Kernel launches since the last reset (plain calls do not count), in all
# and per fetch strategy.
fused_query.launches = 0
fused_query.launches_by_fetch = {"resident": 0, "dma": 0}
