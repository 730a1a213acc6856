"""The paper's block-matrix RMQ in plain PyTorch.

``build`` pads and reshapes the array into ``(num_blocks, block_size)``,
takes per-block leftmost minima and builds a doubling table over them;
``query`` decomposes each range into left partial + fully covered blocks +
right partial, branch-free via masking so a whole batch runs data-parallel.
Port of ``repro/core/block_rmq.py``. Like the jnp version for the Pallas
kernels, this module is the oracle of the CUDA kernels in
``repro_torch.kernels``. The packed half (``PackedBlockRMQ``) keeps one word
plane per tier (``core.packing``): partial scans, the interior lookup and
the three-way merge become plain word mins.

Leftmost ties never rest on a library argmin: every per-row argmin is the
masked-iota min ``min(where(x == vmin, lane, bs))``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch._device import as_index, resolve

from . import packing, sparse_table

__all__ = [
    "BlockRMQ",
    "PackedBlockRMQ",
    "build",
    "build_packed",
    "maxval",
    "query",
    "query_packed",
    "query_words",
]


def maxval(dtype: torch.dtype):
    """The padding / masked-lane value of ``dtype``: +inf or the int max."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


class BlockRMQ(NamedTuple):
    """Static blocked RMQ structure (tensors only — shape carries bs/nb)."""

    x_blocks: torch.Tensor  # (nb, bs), padded with +inf / int-max
    bmin_val: torch.Tensor  # (nb,) per-block minimum value
    bmin_gidx: torch.Tensor  # (nb,) int32 global index of per-block leftmost min
    st: sparse_table.SparseTable  # doubling table over bmin_val


def _mask(rows: torch.Tensor, inside):
    """``rows`` with the lanes outside ``inside`` set to maxval."""
    if inside is None:
        return rows
    return torch.where(inside, rows, maxval(rows.dtype))


def _first_lane(rows: torch.Tensor, vmin: torch.Tensor, inside) -> torch.Tensor:
    """Per row, the first lane holding ``vmin`` (int32), among the lanes of
    ``inside`` only; ``bs`` when none does."""
    bs = rows.shape[1]
    lanes = torch.arange(bs, dtype=torch.int32, device=rows.device)
    hit = rows == vmin[:, None]
    if inside is not None:
        hit = hit & inside
    return torch.where(hit, lanes, bs).min(dim=1).values


def leftmost_min(rows: torch.Tensor, inside=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (min value, leftmost lane int32) of a ``(B, bs)`` tensor.

    The lane is the masked-iota min; the value is read back at that lane, so
    it is the value the leftmost minimum holds (as the reference's
    ``take_along_axis`` does). ``inside`` (a ``(B, bs)`` bool mask) restricts
    each row to a range: a lane outside it carries maxval at position
    ``bs``, past every in-range lane, so it never wins a tie, and a range
    whose minimum is maxval answers with its first lane (the reference's
    masked lanes win that tie: ROADMAP.md §3). A row with no lane inside
    gives ``(maxval, bs)``.
    """
    bs = rows.shape[1]
    rows = _mask(rows, inside)
    lidx = _first_lane(rows, rows.min(dim=1).values, inside)
    val = rows.gather(1, lidx.clamp(max=bs - 1)[:, None].long())[:, 0]
    return val, lidx


def signed_min(rows: torch.Tensor) -> torch.Tensor:
    """Per-row minimum with -0.0 below +0.0, as ``jnp.min`` (and so every
    reference Pallas kernel's ``vmin``) gives it; torch's ``min`` may return
    either zero. float32 rows are reduced over their sign-magnitude keys
    (``core.packing``'s key without its -0.0 fold), which order -0.0 first."""
    if rows.dtype != torch.float32:
        return rows.min(dim=1).values
    b = rows.view(torch.int32)
    key = (b ^ ((b >> 31) & 0x7FFFFFFF)).min(dim=1).values
    return (key ^ ((key >> 31) & 0x7FFFFFFF)).view(torch.float32)


def kernel_leftmost_min(rows: torch.Tensor, inside=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (min value, leftmost lane int32) as the reference kernels
    compute them: ``vmin = min(rows)`` (:func:`signed_min`) and the lane
    ``min(where(rows == vmin, iota, bs))``. The plain version of every CUDA
    kernel's row reduction (``csrc/common.cuh``). It differs from
    :func:`leftmost_min` only in the sign of a zero minimum; ``inside``
    masks as there (``LaneMin::fold``)."""
    rows = _mask(rows, inside)
    vmin = signed_min(rows)
    return vmin, _first_lane(rows, vmin, inside)


def pad_blocks(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """``x`` padded with ``maxval`` to whole blocks, as ``(nb, block_size)``."""
    if block_size % 128 != 0:
        raise ValueError(f"block_size must be a multiple of 128, got {block_size}")
    n = x.shape[0]
    nb = -(-n // block_size)
    pad = torch.full((nb * block_size - n,), maxval(x.dtype), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]).reshape(nb, block_size)


def build(x, block_size: int, *, device=None) -> BlockRMQ:
    """Preprocess ``x`` into the blocked structure on ``device``.

    ``block_size`` must be a multiple of 128, as in the reference (structure
    leaf shapes must match it).
    """
    x = torch.as_tensor(x, device=resolve(device))
    xb = pad_blocks(x, block_size)
    nb = xb.shape[0]
    bmin_val, lidx = leftmost_min(xb)
    bmin_gidx = torch.arange(nb, dtype=torch.int32, device=x.device) * block_size + lidx
    st = sparse_table.build(bmin_val)
    return BlockRMQ(x_blocks=xb, bmin_val=bmin_val, bmin_gidx=bmin_gidx, st=st)


def split(l, r, bs: int):
    """Per query: its first and last block, the lanes of ``l`` and ``r``
    within them, and the last lane of the left partial (``rl`` when the
    range sits in one block, else ``bs - 1``): ``(bl, br, ll, rl, lend)``."""
    bl = l // bs
    br = r // bs
    ll = l - bl * bs
    rl = r - br * bs
    return bl, br, ll, rl, torch.where(bl == br, rl, bs - 1)


def _block_scan(xb, blk, lo, hi):
    """Masked min+argmin of xb[blk, lo:hi+1] per query (the 'ray' primitive).

    Returns (value, global_index); value == maxval when lo > hi (empty range).
    A maxval minimum answers with the range's first index (:func:`leftmost_min`).
    """
    bs = xb.shape[1]
    rows = xb[blk]  # (B, bs) gather of the candidate block
    lanes = torch.arange(bs, dtype=torch.int32, device=xb.device)[None, :]
    inside = (lanes >= lo[:, None]) & (lanes <= hi[:, None])
    val, lidx = leftmost_min(rows, inside)
    return val, blk * bs + lidx


def _pick(v1, i1, v2, i2):
    """Merge candidates; on ties prefer candidate 1 (index-ordered => leftmost)."""
    take1 = v1 <= v2
    return torch.where(take1, v1, v2), torch.where(take1, i1, i2)


def query(s: BlockRMQ, l, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched RMQ. Returns (leftmost argmin index int32, min value).

    Branch-free realization of the paper's Algorithm 6: Case #1 (single
    block) falls out of masking the right partial and the interior away.
    """
    nb, bs = s.x_blocks.shape
    big = maxval(s.x_blocks.dtype)
    dev = s.x_blocks.device
    bl, br, ll, rl, lend = split(as_index(l, dev), as_index(r, dev), bs)

    # Left partial block (covers the whole query when bl == br).
    lv, li = _block_scan(s.x_blocks, bl, ll, lend)

    # Right partial block, only when the query straddles blocks.
    rv, ri = _block_scan(s.x_blocks, br, torch.zeros_like(rl), rl)
    rv = torch.where(br > bl, rv, big)

    # Fully covered interior blocks via the level-2 sparse table.
    has_interior = (br - bl) >= 2
    ilo = torch.clamp(bl + 1, 0, nb - 1)
    ihi = torch.maximum(torch.clamp(br - 1, 0, nb - 1), ilo)
    bi = sparse_table.query(s.st, ilo, ihi)
    iv = torch.where(has_interior, s.bmin_val[bi], big)
    ii = s.bmin_gidx[bi]

    # Index ranges are ordered left < interior < right, so tie-prefer in order.
    v, i = _pick(lv, li, iv, ii)
    v, i = _pick(v, i, rv, ri)
    return i, v


# --- packed variant ---------------------------------------------------------
#
# Level 0 of ``stw`` is the per-block-minimum plane, so the blocked structure
# is exactly two planes: (nb, bs) words + (K, nb) words.


class PackedBlockRMQ(NamedTuple):
    """Blocked RMQ over packed (value, index) words.

    ``blocks`` holds the packed element words (global indices; pads are
    ``pad_word``) for the exact layouts, or the raw maxval-padded values for
    the quantized layout (partial scans stay exact; only the interior tier
    quantizes). ``stw`` is the packed doubling table over per-block minima;
    its index fields are exact in every layout.
    """

    blocks: torch.Tensor  # (nb, bs): packed words, or raw values when quantized
    stw: torch.Tensor  # (K, nb) packed words over per-block leftmost minima


def build_packed(x, block_size: int, spec=None, layout: str = "auto", *, device=None):
    """Packed blocked build; returns ``(PackedBlockRMQ, spec)``.

    Elements pack with global indices before padding, so pads are the
    reserved ``pad_word`` rather than packed maxval (which would blow the
    measured key range of packed32).
    """
    if block_size % 128 != 0:
        raise ValueError(f"block_size must be a multiple of 128, got {block_size}")
    x = torch.as_tensor(x, device=resolve(device))
    n = x.shape[0]
    if spec is None:
        spec = packing.spec_for(x, n, layout)
    if spec.layout == "quantized":
        # Exact partial tiers + quantized interior: raw blocks, exact
        # per-block argmins, then bucket-encode the exact doubling table.
        s = build(x, block_size, device=x.device)
        stw = packing.pack(spec, s.bmin_val[s.st.idx], s.bmin_gidx[s.st.idx])
        return PackedBlockRMQ(blocks=s.x_blocks, stw=stw), spec
    nb = -(-n // block_size)
    xw = torch.full((nb * block_size,), packing.pad_word(spec), dtype=packing.word_dtype(spec), device=x.device)
    xw[:n] = packing.pack(spec, x, torch.arange(n, dtype=torch.int32, device=x.device))
    xwb = xw.reshape(nb, block_size)
    stw = sparse_table.doubling_min(xwb.min(dim=1).values)
    return PackedBlockRMQ(blocks=xwb, stw=stw), spec


def _scan_words(wb, blk, lo, hi, pad: int):
    """Masked word-min of wb[blk, lo:hi+1] per query; ``pad`` when empty."""
    bs = wb.shape[1]
    lanes = torch.arange(bs, dtype=torch.int32, device=wb.device)[None, :]
    inside = (lanes >= lo[:, None]) & (lanes <= hi[:, None])
    return torch.where(inside, wb[blk], pad).min(dim=1).values


def _interior_words(stw, bl, br, nb: int):
    """The fully-covered-blocks candidate as (wa, wb) doubling cells."""
    ilo = torch.clamp(bl + 1, 0, nb - 1)
    ihi = torch.maximum(torch.clamp(br - 1, 0, nb - 1), ilo)
    k = sparse_table.exact_log2(ihi - ilo + 1)
    return stw[k, ilo], stw[k, ihi - (1 << k) + 1]


def query_words(spec, blocks, stw, l, r):
    """Exact-layout blocked query -> the packed min word per query (int32
    tensors ``l``/``r`` on the blocks' device)."""
    nb, bs = blocks.shape
    pad = packing.pad_word(spec)
    bl, br, ll, rl, lend = split(l, r, bs)
    wa, wb = _interior_words(stw, bl, br, nb)
    lw = _scan_words(blocks, bl, ll, lend, pad)
    rw = _scan_words(blocks, br, torch.zeros_like(rl), rl, pad)
    rw = torch.where(br > bl, rw, pad)
    iw = torch.where((br - bl) >= 2, torch.minimum(wa, wb), pad)
    return torch.minimum(torch.minimum(lw, iw), rw)


def query_packed(s: PackedBlockRMQ, spec, l, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched packed RMQ -> ``(idx int32, val)``, exact leftmost ties."""
    dev = s.blocks.device
    l = as_index(l, dev)
    r = as_index(r, dev)
    if spec.layout != "quantized":
        w = query_words(spec, s.blocks, s.stw, l, r)
        return packing.unpack_idx(spec, w), packing.unpack_val(spec, w)

    nb, bs = s.blocks.shape
    big = maxval(s.blocks.dtype)
    bl, br, ll, rl, lend = split(l, r, bs)
    wa, wb = _interior_words(s.stw, bl, br, nb)
    # Exact partial scans over raw blocks; interior cells break bucket ties
    # with exact value gathers from the flat raw plane.
    lv, li = _block_scan(s.blocks, bl, ll, lend)
    rv, ri = _block_scan(s.blocks, br, torch.zeros_like(rl), rl)
    rv = torch.where(br > bl, rv, big)
    flat = s.blocks.reshape(-1)
    ia = packing.unpack_idx(spec, wa)
    ib = packing.unpack_idx(spec, wb)
    va = flat[ia]
    vb = flat[ib]
    collide = (wa >> spec.idx_bits) == (wb >> spec.idx_bits)
    take_a = torch.where(collide, va <= vb, wa <= wb)
    iv = torch.where((br - bl) >= 2, torch.where(take_a, va, vb), big)
    ii = torch.where(take_a, ia, ib)
    v, i = _pick(lv, li, iv, ii)
    v, i = _pick(v, i, rv, ri)
    return i, v
