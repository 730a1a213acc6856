"""Device meshes for the multi-device engines.

A ``Mesh`` names its axes and holds one ``torch.device`` per mesh position,
in mesh order. One process drives every position, a single controller as
the reference's ``shard_map`` programs are: ``core.distributed`` loops over
the positions where the reference runs one program per device, and its
collectives (``pmin``, ``psum``, ``ppermute``) become reductions and index
shifts over the per-shard tensors.

Positions may share a device. On a machine with one card a ``(2, 4)`` mesh
puts eight shards on ``cuda:0`` (the analogue of the reference's
``--xla_force_host_platform_device_count=8``); with several cards the same
mesh spreads its positions round-robin over them. ``physical_devices``
names the distinct devices, so a run on one card never reads as a run on
eight. Port of ``repro/launch/mesh.py``; constructing a mesh allocates
nothing.

A mesh of ranks is the multi-controller form, as PyTorch runs several
devices: one process per device, joined in a ``torch.distributed`` group
(NCCL on the cards, gloo on the CPU). ``make_mesh`` called with no
``devices`` in such a process gives one: its positions are the ranks'
devices in rank order, ``device_mesh`` the matching
``torch.distributed.DeviceMesh`` (the same shape and axis names) and
``rank_device`` this process's own device. The LM steps compute on it with
DTensor leaves (``launch.sharding``, ``train.steps``); the RMQ mesh engines
stay single-controller and take meshes with ``devices`` given.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Mesh",
    "factor_2d",
    "make_group_mesh",
    "make_mesh",
    "make_production_mesh",
    "set_mesh",
]


class Mesh:
    """Named axes over an ndarray of ``torch.device``, one per position.

    ``shape[name]`` is an axis's size, as in the reference; ``devices`` has
    the mesh's shape; ``physical_devices`` lists the distinct devices in
    order of first appearance.
    """

    def __init__(self, devices, axis_names: Sequence[str], *, device_mesh=None, rank_device=None):
        devs = np.empty(np.shape(devices), dtype=object)
        for pos, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:  # the tensors' own name for it
                d = torch.device("cuda", torch.cuda.current_device())
            devs[pos] = d
        axis_names = tuple(axis_names)
        if devs.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devs.shape} needs {devs.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must be distinct, got {axis_names}")
        self.devices = devs
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, devs.shape))
        self.physical_devices: Tuple[torch.device, ...] = tuple(dict.fromkeys(devs.flat))
        self.device_mesh = device_mesh  # a mesh of ranks only
        self.rank_device = rank_device

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        what = "ranks" if self.device_mesh is not None else "positions"
        return f"Mesh({axes}; {self.size} {what} on {[str(d) for d in self.physical_devices]})"


def factor_2d(ndev: int):
    """Squarest (a, b) factoring of a device count, a <= b.

    The one definition of how ``--qshard 2d`` splits a flat device fleet
    into a (structure, batch) grid.
    """
    a = int(ndev**0.5)
    while ndev % a:
        a -= 1
    return a, ndev // a


def _devices_for(count: int, devices):
    """``count`` devices round-robin over ``devices``: ``None`` means the
    visible CUDA devices (raising when there is none: no CPU fallback), a
    single device name or ``torch.device`` puts every position on it, and a
    sequence is cycled."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(devices=None) spans the CUDA devices, and CUDA is not "
                "available; pass devices='cpu' for a CPU mesh"
            )
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        pool = [torch.device(devices)]
    else:
        pool = [torch.device(d) for d in devices]
    if not pool:
        raise ValueError("a mesh needs at least one device")
    return [pool[i % len(pool)] for i in range(count)]


def _rank_mesh(shape: tuple, axes) -> Mesh:
    """The mesh of the ranks of the default process group: rank ``r`` at
    flat position ``r``, on its own device (the current CUDA device under
    NCCL, else the CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of ranks of shape {shape} needs {math.prod(shape)} ranks; the group has {world}")
    if "nccl" in str(dist.get_backend()):
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    names = [None] * world
    dist.all_gather_object(names, str(dev))
    grid = np.empty(world, dtype=object)
    grid[:] = [torch.device(n) for n in names]
    device_mesh = init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axes))
    return Mesh(grid.reshape(shape), axes, device_mesh=device_mesh, rank_device=dev)


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (e.g. ``(2, 4)``, ``("data", "model")``).

    ``devices=None`` spreads the positions round-robin over the visible
    CUDA devices, or, in a process of an initialised ``torch.distributed``
    group, gives the mesh of its ranks (module docstring; the shape must
    hold every rank); ``devices="cpu"`` (or any one device) puts them all
    on it; a sequence of devices is cycled in mesh order.
    """
    shape = tuple(int(s) for s in shape)
    if devices is None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return _rank_mesh(shape, axes)
    count = math.prod(shape)
    grid = np.empty(count, dtype=object)
    grid[:] = _devices_for(count, devices)
    return Mesh(grid.reshape(shape), axes)


def make_group_mesh(devices, axes=("shard",)) -> Mesh:
    """1-D mesh over an explicit device subset (a replica fleet carves its
    devices into disjoint per-replica groups, each one of these)."""
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid, axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shape: 16x16 (256 positions) or 2x16x16
    (512), on the ``meta`` device: a shape to plan against, holding no
    memory."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices="meta")


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Context manager yielding ``mesh``. The reference's activates jit's
    ambient mesh; the port's engines always take their mesh explicitly, so
    this only scopes a block to it."""
    yield mesh
