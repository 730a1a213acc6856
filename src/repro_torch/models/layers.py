"""Shared neural-net building blocks (plain PyTorch functions).

Port of ``repro/models/layers.py``. Conventions:
  * params are plain nested dicts of tensors;
  * activations run in ``cfg.dtype`` (bf16 when serving), norms in float32;
  * weights are flat ``(in, out)`` matrices used as ``x @ w``.

Matmul precision: ``dense`` multiplies in the activations' dtype. cuBLAS
accumulates a bf16 GEMM in float32 and rounds the output to bf16, as XLA
does for the reference's einsum, provided
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is
off (its split-K reductions would otherwise run in bf16; PyTorch's default
is on). A float32 GEMM is float32 on the card only while
``torch.backends.cuda.matmul.allow_tf32`` is off. ``reference_matmul``
holds both flags off for the span of a model forward, whatever the
caller's settings, and restores them after. ``unembed`` upcasts both
operands to float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "dense",
    "swiglu",
    "embed",
    "unembed",
    "rope",
    "softmax_cross_entropy",
    "scalar",
    "reference_matmul",
]


@contextlib.contextmanager
def reference_matmul():
    """cuBLAS GEMMs with float32 accumulation and a float32 GEMM without
    TF32, for the ``with`` block; the caller's flags come back after."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def scalar(value: float, dtype) -> torch.Tensor:
    """``value`` rounded to ``dtype``, as a 0-dim CPU tensor: an op on CUDA
    tensors takes it as a scalar argument, where a 0-dim CUDA tensor made
    from a Python number would cost a host-to-device copy and a stream
    synchronize."""
    return torch.tensor(value, dtype=dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + weight``; returns ``x.dtype``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(F.silu(g) * u, w_down)


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``table`` for int32 or int64 ``tokens``, cast to ``dtype``."""
    return table[tokens.long()].to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits (float32 for a stable loss/softmax)."""
    return torch.matmul(x.float(), table.float().t())


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq  # (..., L, half)
    return torch.cos(ang), torch.sin(ang)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over split halves (not interleaved pairs).

    x: (B, L, H, hd); positions: (B, L) or (L,).
    """
    cos, sin = _rope_angles(positions, x.shape[-1], theta)  # (B, L, half)
    cos = cos[..., None, :]  # (B, L, 1, half)
    sin = sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean token cross-entropy. logits f32 (B, L, Vpad); labels int (B, L).

    The padded vocab entries are masked with -1e30 so they take no mass.
    """
    if logits.shape[-1] > vocab_size:
        logits = logits.clone()
        logits[..., vocab_size:] = -1e30
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
