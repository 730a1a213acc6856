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

``fused_query_packed`` does the same over the packed word structures of
``core.packing`` (``csrc/fused_query_packed.cu``, replacing the reference's
``fused_query_packed``): packed32 with both fetches, and quantized; and
packed64, which the reference serves with jnp ops only. The source notes of
the kernels give their bounds and designs.

Each launch adds its batch size to the counter
``query_kernel_queries_total{kernel, layout}`` of
``obs.metrics.default_registry()`` (plain calls add nothing).
"""

from __future__ import annotations

import logging
import threading

import torch

from repro_torch._device import as_index
from repro_torch.core import block_rmq, packing
from repro_torch.core.block_rmq import maxval, signed_min, split
from repro_torch.core.sparse_table import exact_log2
from repro_torch.obs.metrics import default_registry

from . import _build
from .rmq_query import rmq_partials_plain
from .tuning import DEFAULT_TILE, MAX_TILE, resolve_fetch

__all__ = [
    "fused_query",
    "fused_query_packed",
    "fused_query_packed_plain",
    "fused_query_plain",
    "interior_tables",
    "DEFAULT_TILE",
]

_logger = logging.getLogger(__name__)
_DTYPES = {torch.float32: "f32", torch.int32: "i32"}
# The C entry points, by value dtype (and packed layout).
_ENTRY = {dt: f"repro_fused_query_{k}" for dt, k in _DTYPES.items()}
_PACKED_ENTRY = {
    (layout, dt): f"repro_fused_query_{layout}_{k}"
    for layout in packing.PACKED_LAYOUTS
    for dt, k in _DTYPES.items()
}
_count_lock = threading.Lock()
_warned_materialize = False


def _count_queries(kernel: str, layout: str, b: int) -> None:
    default_registry().counter("query_kernel_queries_total", kernel=kernel, layout=layout).inc(b)


def interior_tables(bmin_val: torch.Tensor, bmin_gidx: torch.Tensor, st_idx: torch.Tensor):
    """Value-augmented doubling tables for the dma fetch strategy.

    ``st_val[k, p] = bmin_val[st_idx[k, p]]`` and ``st_gidx`` likewise:
    O(K * nb) gathers, computed once at build.
    """
    return bmin_val[st_idx], bmin_gidx[st_idx]


def decompose(l, r, nb: int, bs: int):
    """The per-query scalars of the reference wrappers (fused_query.py:225-237
    and :519-531): ``(bl, br, ls, le, re, hasint, k, ilo, bpos)``."""
    bl, br, ls, re, le = split(l, r, bs)
    ilo = torch.clamp(bl + 1, 0, nb - 1)
    ihi = torch.maximum(torch.clamp(br - 1, 0, nb - 1), ilo)
    k = exact_log2(ihi - ilo + 1)
    bpos = ihi - (1 << k) + 1
    return bl, br, ls, le, re, (br - bl) >= 2, k, ilo, bpos


def merge_interior(pv, pi, iv, ii, int_start):
    """The final merge of every blocked query (fused_query.py:157-169): the
    partial wins only when strictly smaller, or tied with an index left of
    the interior's first element ``int_start``. Returns (idx, val)."""
    prefer_partial = (pv < iv) | ((pv == iv) & (pi < int_start))
    return torch.where(prefer_partial, pi, ii), torch.where(prefer_partial, pv, iv)


def fused_query_plain(
    x_blocks, bmin_val, bmin_gidx, st_idx, l, r, *, st_val=None, st_gidx=None, fetch="resident"
):
    """The reference kernel's arithmetic in PyTorch, the whole batch at once.

    The scalar decomposition (:func:`decompose`, with the reference
    ``exact_log2``), the masked-iota partials (``rmq_partials_plain``), the
    interior cells of ``fetch`` and the merges of ``fused_query.py:157-169``.
    ``l``/``r`` are int32 tensors on ``x_blocks``'s device.
    """
    nb, bs = x_blocks.shape
    bl, br, ls, le, re, hasint, k, ilo, bpos = decompose(l, r, nb, bs)
    pv, pi = rmq_partials_plain(x_blocks, bl, br, ls, le, re)

    if fetch == "resident":
        a = st_idx[k, ilo]
        b = st_idx[k, bpos]
        av, bv, ai, bi = bmin_val[a], bmin_val[b], bmin_gidx[a], bmin_gidx[b]
    else:
        av, bv = st_val[k, ilo], st_val[k, bpos]
        ai, bi = st_gidx[k, ilo], st_gidx[k, bpos]
    # The value is the reference's ``jnp.minimum(av, bv)``: -0.0 when either
    # cell holds it and the other a zero (ROADMAP.md §3); the index is the lo
    # cell's on ties.
    iv = signed_min(torch.stack([av, bv], dim=1))
    iv = torch.where(hasint, iv, maxval(x_blocks.dtype))
    ii = torch.where(av <= bv, ai, bi)
    return merge_interior(pv, pi, iv, ii, (bl + 1) * bs)


def _check_leaf(name, t, dtype, device, ndim, what="fused_query"):
    if t.dtype != dtype or t.device != device or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {ndim}-D {dtype} tensor on {device}, "
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
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}] warps per thread block, got {tile}")
    _check_leaf("x_blocks", x_blocks, x_blocks.dtype, dev, 2)
    _build.check_pieces(x_blocks, "x_blocks", "fused_query")
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
    _build.launch(
        _ENTRY[x_blocks.dtype], f"fused_query[{fetch}]", dev,
        x_blocks.data_ptr(), *ptrs, l.data_ptr(), r.data_ptr(), idx.data_ptr(), val.data_ptr(),
        b, nb, bs, int(fetch == "dma"), tile,
    )
    with _count_lock:
        fused_query.launches += 1
        fused_query.launches_by_fetch[fetch] += 1
    _count_queries("fused_query", "unpacked", b)
    return idx, val


# Kernel launches since the last reset (plain calls do not count), in all
# and per fetch strategy.
fused_query.launches = 0
fused_query.launches_by_fetch = {"resident": 0, "dma": 0}


# --- packed megakernel ------------------------------------------------------
#
# packed32 and packed64: every table the kernel touches is one plane of
# words (int32, int64), so each partial is a masked word min, the interior
# is min(stw[k, ilo], stw[k, bpos]) and the answer the min of three words.
# quantized: raw-value partials, (bucket, exact argmin) interior words whose
# bucket ties fall back to the exact values bmin_val[idx // bs]; resident
# only. The reference has no packed64 kernel (its jnp query serves it); the
# port's answers equal ``core.block_rmq.query_packed``'s bit for bit.


def fused_query_packed_plain(blocks, stw, l, r, *, spec, bmin_val=None):
    """The reference kernels' arithmetic (``_kernel_packed`` and
    ``_kernel_quantized``, fused_query.py:351-477) in PyTorch, the whole
    batch at once. packed32 and packed64 are the min word of
    ``block_rmq.query_words`` (both fetches read the same two cells),
    unpacked."""
    if spec.layout in ("packed32", "packed64"):
        w = block_rmq.query_words(spec, blocks, stw, l, r)
        return packing.unpack_idx(spec, w), packing.unpack_val(spec, w)

    nb, bs = blocks.shape
    bl, br, ls, le, re, hasint, k, ilo, bpos = decompose(l, r, nb, bs)
    wa = stw[k, ilo]
    wb = stw[k, bpos]
    pv, pi = rmq_partials_plain(blocks, bl, br, ls, le, re)
    ai = packing.unpack_idx(spec, wa)
    bi = packing.unpack_idx(spec, wb)
    ava = bmin_val[ai // bs]
    avb = bmin_val[bi // bs]
    collide = (wa >> spec.idx_bits) == (wb >> spec.idx_bits)
    take_a = torch.where(collide, ava <= avb, wa <= wb)
    iv = torch.where(hasint, torch.where(take_a, ava, avb), maxval(blocks.dtype))
    ii = torch.where(take_a, ai, bi)
    return merge_interior(pv, pi, iv, ii, (bl + 1) * bs)


def fused_query_packed(
    blocks: torch.Tensor,  # (nb, bs): packed words | raw values (quantized)
    stw: torch.Tensor,  # (K, nb) packed doubling table over block minima
    l,
    r,
    *,
    spec,  # packing.PackSpec
    bmin_val: torch.Tensor | None = None,  # (nb,) exact minima (quantized only)
    tile: int = DEFAULT_TILE,
    fetch: str = "auto",
):
    """Packed fused blocked RMQ. Returns (idx (B,) int32, value (B,)).

    One kernel launch per batch on the card over single-plane structures:
    packed32 and packed64 (int32 and int64 words; both fetch strategies,
    which read the same two cells and launch one body) and quantized
    (resident only). ``blocks`` rows are read in 16-byte pieces: a multiple
    of 128 values from a 16-byte aligned base.
    """
    if spec.layout not in packing.PACKED_LAYOUTS:
        raise ValueError(
            f"fused_query_packed wants one of {'|'.join(packing.PACKED_LAYOUTS)}, got {spec.layout!r}"
        )
    nb, bs = blocks.shape
    fetch = resolve_fetch(fetch, nb)
    if spec.layout == "quantized":
        if bmin_val is None:
            raise ValueError("quantized fused_query_packed needs the bmin_val plane")
        fetch = "resident"  # the exact-fallback hop lives in the resident plane
    dev = blocks.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    if l.ndim != 1 or l.shape != r.shape:
        raise ValueError(f"l/r must be equal-shape 1-D, got {tuple(l.shape)} / {tuple(r.shape)}")
    if dev.type == "cpu":
        return fused_query_packed_plain(blocks, stw, l, r, spec=spec, bmin_val=bmin_val)
    if dev.type != "cuda":
        raise ValueError(f"fused_query_packed runs on cuda or cpu tensors, got {dev}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be in [1, {MAX_TILE}] warps per thread block, got {tile}")
    val_dtype = getattr(torch, spec.dtype)
    if val_dtype not in _DTYPES:
        raise TypeError(f"fused_query_packed takes float32 or int32 values, got {spec.dtype}")
    what = "fused_query_packed"
    _check_leaf("stw", stw, packing.word_dtype(spec), dev, 2, what)
    if stw.shape[1] != nb:
        raise ValueError(f"{what}: stw must have nb = {nb} columns, got {tuple(stw.shape)}")
    word_dtype = val_dtype if spec.layout == "quantized" else packing.word_dtype(spec)
    _check_leaf("blocks", blocks, word_dtype, dev, 2, what)
    _build.check_pieces(blocks, "blocks", what)
    if spec.layout == "quantized":
        _check_leaf("bmin_val", bmin_val, val_dtype, dev, 1, what)
        if bmin_val.shape[0] != nb:
            raise ValueError(f"{what}: bmin_val must have nb = {nb} entries")
    l = l.contiguous()
    r = r.contiguous()
    b = l.shape[0]
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    val = torch.empty(b, dtype=val_dtype, device=dev)
    if b == 0:
        return idx, val
    name = _PACKED_ENTRY[spec.layout, val_dtype]
    if spec.layout == "packed32":
        body = f"packed32[{fetch}]"
        args = (
            blocks.data_ptr(), stw.data_ptr(), l.data_ptr(), r.data_ptr(), idx.data_ptr(),
            val.data_ptr(), b, nb, bs, spec.idx_bits, spec.kmin, int(fetch == "dma"), tile,
        )
    elif spec.layout == "packed64":
        body = "packed64"
        args = (
            blocks.data_ptr(), stw.data_ptr(), l.data_ptr(), r.data_ptr(), idx.data_ptr(),
            val.data_ptr(), b, nb, bs, tile,
        )
    else:
        body = "quantized"
        args = (
            blocks.data_ptr(), stw.data_ptr(), bmin_val.data_ptr(), l.data_ptr(), r.data_ptr(),
            idx.data_ptr(), val.data_ptr(), b, nb, bs, spec.idx_bits, tile,
        )
    _build.launch(name, f"fused_query_packed[{body}]", dev, *args)
    with _count_lock:
        fused_query_packed.launches += 1
        fused_query_packed.launches_by_body[body] += 1
    _count_queries("fused_query_packed", spec.layout, b)
    return idx, val


# Kernel launches since the last reset (plain calls do not count), in all and
# per body and fetch.
fused_query_packed.launches = 0
fused_query_packed.launches_by_body = {
    "packed32[resident]": 0,
    "packed32[dma]": 0,
    "packed64": 0,
    "quantized": 0,
}
