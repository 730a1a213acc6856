"""Plain PyTorch oracles for the CUDA kernels (kernel checks assert against these)."""

from __future__ import annotations

import torch

from repro_torch.core.block_rmq import leftmost_min, maxval

__all__ = ["block_min_ref", "rmq_partials_ref"]


def block_min_ref(x_blocks: torch.Tensor):
    """Per-block (min value, leftmost local argmin int32).

    ``torch.argmin`` returns the first minimal index, as ``jnp.argmin`` does
    in the reference oracle; the kernels themselves never rely on it.
    """
    lidx = torch.argmin(x_blocks, dim=1)
    val = x_blocks.gather(1, lidx[:, None])[:, 0]
    return val, lidx.to(torch.int32)


def rmq_partials_ref(x_blocks, bl, br, lstart, lend, rend):
    """Combined partial-block candidate per query.

    Left partial = min of x_blocks[bl, lstart:lend+1] (always non-empty);
    right partial = min of x_blocks[br, 0:rend+1] (masked off unless
    br > bl). Returns their leftmost-tie merge as (value, global idx int32).
    Each side is the first minimal lane of its range (``leftmost_min``): the
    leftmost element's bits, as the reference's argmin gives them, and a
    maxval-only range answers with its first index (ROADMAP.md §3).
    """
    bs = x_blocks.shape[1]
    big = maxval(x_blocks.dtype)
    lanes = torch.arange(bs, dtype=torch.int32, device=x_blocks.device)[None, :]

    lv, li = leftmost_min(x_blocks[bl], (lanes >= lstart[:, None]) & (lanes <= lend[:, None]))
    lg = bl * bs + li

    rv, ri = leftmost_min(x_blocks[br], lanes <= rend[:, None])
    rv = torch.where(br > bl, rv, big)
    rg = br * bs + ri

    take_l = lv <= rv
    return torch.where(take_l, lv, rv), torch.where(take_l, lg, rg)
