"""Plain PyTorch oracles for the CUDA kernels (kernel checks assert against these)."""

from __future__ import annotations

import torch

from repro_torch.core.block_rmq import maxval

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
    """
    bs = x_blocks.shape[1]
    big = maxval(x_blocks.dtype)
    lanes = torch.arange(bs, dtype=torch.int32, device=x_blocks.device)[None, :]

    ml = torch.where((lanes >= lstart[:, None]) & (lanes <= lend[:, None]), x_blocks[bl], big)
    li = torch.argmin(ml, dim=1).to(torch.int32)
    lv = ml.gather(1, li[:, None].long())[:, 0]
    lg = bl * bs + li

    mr = torch.where(lanes <= rend[:, None], x_blocks[br], big)
    ri = torch.argmin(mr, dim=1).to(torch.int32)
    rv = mr.gather(1, ri[:, None].long())[:, 0]
    rv = torch.where(br > bl, rv, big)
    rg = br * bs + ri

    take_l = lv <= rv
    return torch.where(take_l, lv, rv), torch.where(take_l, lg, rg)
