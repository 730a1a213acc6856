"""Int8 gradient compression with error feedback.

Port of ``repro/optim/compress.py``. At multi-pod scale the cross-pod
gradient all-reduce is the scarcest bandwidth; this transform quantizes
each gradient leaf to int8 with a per-leaf scale before the reduction and
decompresses after, carrying the quantization residual to the next step
(error feedback) so convergence is preserved. ``torch.round``, like
``jnp.round``, rounds half to even.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch._tree import tree_map

__all__ = ["EFState", "init_ef", "compress", "decompress", "ef_compress_grads"]


class EFState(NamedTuple):
    residual: Any  # fp32 tree, same structure as grads


def init_ef(grads_like) -> EFState:
    return EFState(
        residual=tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like)
    )


def compress(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization. Returns (q, scale). The
    scale is the whole tensor's, on a DTensor too: its max reduces over
    every shard."""
    g32 = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads, ef: EFState):
    """Quantize grads with error feedback. Returns (dequantized grads, new EF)."""

    def one(g, r):
        target = g.to(torch.float32) + r
        deq = decompress(*compress(target))
        return deq, target - deq

    out = tree_map(one, grads, ef.residual)  # a (deq, residual) per leaf
    deq, res = (tree_map(lambda _, t: t[i], grads, out) for i in range(2))
    return deq, EFState(residual=res)
