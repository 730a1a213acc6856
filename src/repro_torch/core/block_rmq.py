"""The paper's block-matrix RMQ in plain PyTorch.

``build`` pads and reshapes the array into ``(num_blocks, block_size)``,
takes per-block leftmost minima and builds a doubling table over them;
``query`` decomposes each range into left partial + fully covered blocks +
right partial, branch-free via masking so a whole batch runs data-parallel.
Port of ``repro/core/block_rmq.py`` (unpacked half). Like the jnp version
for the Pallas kernels, this module is the oracle of the CUDA kernels in
``repro_torch.kernels``.

Leftmost ties never rest on a library argmin: every per-row argmin is the
masked-iota min ``min(where(x == vmin, lane, bs))``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch._device import as_index, resolve

from . import sparse_table

__all__ = ["BlockRMQ", "build", "maxval", "query"]


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


def leftmost_min(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (min value, leftmost lane int32) of a ``(B, bs)`` tensor.

    The lane is the masked-iota min; the value is read back at that lane, so
    it is the value the leftmost minimum holds (as the reference's
    ``take_along_axis`` does).
    """
    bs = rows.shape[1]
    vmin = rows.min(dim=1).values
    lanes = torch.arange(bs, dtype=torch.int32, device=rows.device)
    lidx = torch.where(rows == vmin[:, None], lanes, bs).min(dim=1).values
    val = rows.gather(1, lidx[:, None].long())[:, 0]
    return val, lidx


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


def _block_scan(xb, blk, lo, hi):
    """Masked min+argmin of xb[blk, lo:hi+1] per query (the 'ray' primitive).

    Returns (value, global_index); value == maxval when lo > hi (empty range).
    """
    bs = xb.shape[1]
    rows = xb[blk]  # (B, bs) gather of the candidate block
    lanes = torch.arange(bs, dtype=torch.int32, device=xb.device)[None, :]
    inside = (lanes >= lo[:, None]) & (lanes <= hi[:, None])
    masked = torch.where(inside, rows, maxval(xb.dtype))
    val, lidx = leftmost_min(masked)
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
    l = as_index(l, dev)
    r = as_index(r, dev)

    bl = l // bs
    br = r // bs
    ll = l - bl * bs
    rl = r - br * bs

    # Left partial block (covers the whole query when bl == br).
    lend = torch.where(bl == br, rl, bs - 1)
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
