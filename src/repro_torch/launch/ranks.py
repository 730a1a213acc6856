"""Ranks: one process per device, joined in a ``torch.distributed`` group.

The LM steps run on several devices as PyTorch runs them, multi-controller
(``launch/mesh.py``, ``train/steps.py``): every rank runs the same program
on its own device, NCCL between cards and gloo on the CPU. A group comes
from one of two places:

  * ``torchrun`` (``python -m torch.distributed.run``) starts the processes
    and sets ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``; ``join`` then
    joins its group;
  * ``spawn`` starts ``world`` processes itself (``torch.multiprocessing``)
    and calls ``fn(rank, *args)`` in each, once the group is up; the
    rendezvous is ``init_method`` (a ``file://`` path, say), or a free TCP
    port on ``localhost``.

Rank ``r`` uses ``cuda:r`` (``LOCAL_RANK`` under ``torchrun``) or the CPU.
"""

from __future__ import annotations

import os
import socket

import torch

__all__ = ["join", "launched", "leave", "spawn"]


def launched() -> bool:
    """Whether ``torchrun`` started this process (its environment names the
    group)."""
    return "WORLD_SIZE" in os.environ


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def join(device_type: str) -> int:
    """Join ``torchrun``'s group (its environment names the rendezvous);
    returns the rank."""
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(_backend(device_type))
    return dist.get_rank()


def leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, init_method: str, device_type: str, fn, args) -> None:
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(_backend(device_type), init_method=init_method, rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device_type: str = "cuda", init_method: str | None = None) -> None:
    """Run ``fn(rank, *args)`` in ``world`` new processes, one per device,
    joined in a group; returns when all have ended, and raises if one
    failed. ``fn`` must be importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    mp.spawn(_entry, args=(world, init_method, device_type, fn, args), nprocs=world, join=True)
