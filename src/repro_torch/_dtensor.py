"""DTensor helpers for the LM steps on a mesh of ranks.

A process that never built a mesh of ranks has not imported
``torch.distributed.tensor`` (about 1.5 s), and then holds no DTensor:
``is_dtensor`` asks without importing it, so the one-device path pays
nothing. ``place`` turns a full tensor, which every rank holds alike, into
a DTensor by slicing out the rank's own shard: no collective runs, and a
dimension sharded over several mesh axes splits over them major to minor in
mesh order, as ``torch.distributed.tensor.distribute_tensor`` splits it.

The rest serve the model code where it computes on local shards
(``models/``): ``on_rows`` runs a computation on each rank's batch rows
with whole parameters (``row_placements``, ``whole``), ``shard_span``
gives a rank's slice of a dimension, and ``sum_over`` sums a local tensor
over ranks with the gradient that a loss computed alike on every rank
needs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

__all__ = [
    "full",
    "is_dtensor",
    "local_device",
    "on_rows",
    "place",
    "row_placements",
    "shard_span",
    "sum_over",
    "whole",
]


def is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def full(x):
    """The whole tensor of a DTensor (a collective: every rank calls it),
    or ``x`` itself."""
    return x.full_tensor() if is_dtensor(x) else x


def local_device(device_mesh) -> torch.device:
    """This rank's device on ``device_mesh``."""
    if device_mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_mesh.device_type)


def place(t, device_mesh, placements):
    """``t`` (a tensor or numpy array, whole and alike on every rank, or a
    DTensor) as a DTensor on ``device_mesh`` with ``placements``, its local
    shard a fresh copy on the rank's device; a DTensor laid out so already
    comes back as it is."""
    from torch.distributed.tensor import DTensor, Shard

    placements = tuple(placements)
    if is_dtensor(t):
        if t.device_mesh == device_mesh:
            return t if tuple(t.placements) == placements else t.redistribute(device_mesh, placements)
        t = t.full_tensor()
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t, order="C"))
    local = t
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n, c = device_mesh.size(i), device_mesh.get_local_rank(i)
            size = local.shape[p.dim]
            if size % n:
                raise ValueError(f"dimension {p.dim} of {tuple(t.shape)} does not split over {n} ranks")
            local = local.narrow(p.dim, c * (size // n), size // n)
    local = local.to(device=local_device(device_mesh), copy=True).contiguous()
    return DTensor.from_local(
        local, device_mesh, placements, run_check=False, shape=t.shape, stride=_contiguous_stride(t.shape)
    )


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def shard_span(t, dim: int) -> tuple:
    """``(start, stop)`` of dimension ``dim`` of the DTensor ``t`` that this
    rank holds (the whole dimension where no mesh axis shards it; several
    axes split it major to minor in mesh order)."""
    from torch.distributed.tensor import Shard

    mesh, start, size = t.device_mesh, 0, t.shape[dim]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            start += mesh.get_local_rank(i) * size
    return start, start + size


def row_placements(t) -> list:
    """Placements that keep ``t``'s batch rows (dimension 0) split as they
    are and everything else whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in t.placements]


def whole(t, rows) -> torch.Tensor:
    """The DTensor ``t`` (a parameter) whole, as a local tensor, for a rank
    that computes on the batch rows ``rows`` place: its gradient sums over
    the ranks that hold other rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return t.full_tensor(grad_placements=[Partial() if isinstance(r, Shard) else Replicate() for r in rows])


def on_rows(fn, params: dict, *xs):
    """``fn(params, *xs)`` on this rank's batch rows (those of ``xs[0]``)
    with the whole params, on local tensors; its tensors come back as
    DTensors over the same rows. For a computation that mixes no rows and
    that DTensor cannot run on some torch releases."""
    from torch.distributed.tensor import DTensor

    from repro_torch._tree import tree_map

    mesh, rows = xs[0].device_mesh, row_placements(xs[0])
    out = fn({k: whole(v, rows) for k, v in params.items()}, *(x.redistribute(mesh, rows).to_local() for x in xs))
    return tree_map(lambda t: DTensor.from_local(t, mesh, rows), out)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        import torch.distributed as dist

        t = t.clone()
        for group in groups:
            dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over(t: torch.Tensor, device_mesh, axes) -> torch.Tensor:
    """The local tensor ``t`` summed over the ranks of the mesh ``axes`` (an
    all-reduce). Its gradient reaches each rank's ``t`` whole, which is
    right when every rank of those axes uses the sum alike (a loss, which
    every rank computes the same)."""
    axes = tuple(axes)
    if not axes:
        return t
    return _SumOverRanks.apply(t, tuple(device_mesh.get_group(i) for i in axes))
