"""Attention: GQA with RoPE, streaming (flash-style) softmax, KV cache.

Port of ``repro/models/attention.py``. ``flash_attention`` never holds the
(Lq, Lk) score matrix: a Python loop over KV chunks carries the running
max, normalizer and accumulator (the online-softmax recurrence), so
activation memory is O(Lq * chunk). K/V are repeated to the full head count
as in the reference's "heads" mode. The reference's sharding and unroll
arguments (``attn_shard``, ``dp_axes``, ``model_axis``, ``unroll``) steer
XLA across a mesh; this one-device port takes none of them.

Precision, as the reference's ``preferred_element_type=float32`` asks: the
two products of each chunk (QK^T and PV) take their operands in the compute
dtype and multiply them upcast to float32, so every product of two bf16
values is exact and the sum is float32 (a bf16 value is also exact in TF32,
so the upcast stays exact if TF32 is on; a float32 run needs
``torch.backends.cuda.matmul.allow_tf32`` off). ``q`` is pre-scaled in the
compute dtype and ``p`` rounded to it before the PV product, as the
reference does. The softmax state is float32.

Masks are built per chunk pair; ``is_global`` may be a bool tensor, so
gemma3's local:global pattern rides a per-layer flag.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import scalar

__all__ = ["flash_attention", "decode_attention", "KVCache"]

_NEG = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (num_layers, B, S, KV, hd)
    v: torch.Tensor  # (num_layers, B, S, KV, hd)
    length: int  # tokens currently valid


def _mask(q_pos, k_pos, *, causal: bool, window: int, is_global, limit):
    """(Lq, Lk) boolean mask for one chunk pair; window==0 means full."""
    m = k_pos[None, :] < limit
    if causal:
        m = m & (q_pos[:, None] >= k_pos[None, :])
    if window:
        in_win = (q_pos[:, None] - k_pos[None, :]) < window
        if is_global is None:
            m = m & in_win
        else:  # per-layer flag (a bool tensor): full vs local
            m = m & (in_win | torch.as_tensor(is_global, dtype=torch.bool, device=m.device))
    return m


def flash_attention(
    q: torch.Tensor,  # (B, Lq, H, hd)
    k: torch.Tensor,  # (B, Lk, KV, hd)
    v: torch.Tensor,  # (B, Lk, KV, hd)
    *,
    causal: bool = True,
    window: int = 0,
    is_global=None,
    q_offset: int = 0,
    kv_chunk: int = 1024,
    kv_valid=None,
) -> torch.Tensor:
    """Online-softmax attention. Returns (B, Lq, H, hd).

    q_offset: position of q[0] relative to k[0] (for prefill continuation).
    kv_valid: optional int — keys at positions >= kv_valid are masked.
    """
    b, lq, h, hd = q.shape
    lk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(hd)
    cdt = q.dtype
    dev = q.device

    kv_chunk = min(kv_chunk, lk)
    pad = (-lk) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nk = (lk + pad) // kv_chunk
    # repeat K/V to full heads (jnp.repeat along the head axis)
    kc = k.reshape(b, nk, kv_chunk, kv, hd).repeat_interleave(rep, dim=3)
    vc = v.reshape(b, nk, kv_chunk, kv, hd).repeat_interleave(rep, dim=3)

    q = q * scalar(scale, cdt)
    q32 = q.float()
    q_pos = q_offset + torch.arange(lq, dtype=torch.int32, device=dev)
    limit = lk if kv_valid is None else kv_valid

    m = torch.full((b, h, lq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, lq, hd), dtype=torch.float32, device=dev)
    for j in range(nk):
        kj, vj = kc[:, j], vc[:, j]  # (B, C, H, hd)
        k_pos = j * kv_chunk + torch.arange(kv_chunk, dtype=torch.int32, device=dev)
        s = torch.einsum("bqhd,bjhd->bhqj", q32, kj.float())
        msk = _mask(q_pos, k_pos, causal=causal, window=window, is_global=is_global, limit=limit)
        s = torch.where(msk[None, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhqj,bjhd->bhqd", p.to(cdt).float(), vj.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, H, Lq, hd)
    return out.transpose(1, 2).to(cdt)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    cache_k: torch.Tensor,  # (B, S, KV, hd)
    cache_v: torch.Tensor,
    length,  # valid cache entries (q attends to < length): int or int tensor
    *,
    window: int = 0,
    is_global=None,
) -> torch.Tensor:
    """Single-token attention against a cache. Returns (B, 1, H, hd).

    The grouped (kv, rep) form: no KV repeat traffic. Products as in
    ``flash_attention`` (operands upcast to float32).
    """
    b, _, h, hd = q.shape
    s_len, kv = cache_k.shape[1], cache_k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(hd)
    cdt = q.dtype
    dev = q.device
    qg = (q * scalar(scale, cdt)).reshape(b, 1, kv, rep, hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), cache_k.to(cdt).float())
    k_pos = torch.arange(s_len, dtype=torch.int32, device=dev)
    mask = k_pos < length
    if window:
        in_win = (length - 1 - k_pos) < window
        if is_global is None:
            mask = mask & in_win
        else:
            mask = mask & (in_win | torch.as_tensor(is_global, dtype=torch.bool, device=dev))
    s = torch.where(mask[None, None, None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrqs,bskd->bkrqd", p.to(cdt).float(), cache_v.to(cdt).float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
    return out.to(cdt)
