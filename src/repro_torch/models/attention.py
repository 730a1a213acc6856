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

On DTensors (a mesh of ranks) ``flash_attention`` runs on each rank's rows
and heads as local tensors (``_flash_attention_ranks``), and
``decode_attention`` on each rank's slots of a sequence-sharded cache, its
softmax and weighted sum reduced over the ranks that share the rows
(``_decode_attention_ranks``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch._dtensor import is_dtensor, shard_span

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
    if is_dtensor(q):
        return _flash_attention_ranks(
            q, k, v, causal=causal, window=window, is_global=is_global, q_offset=q_offset,
            kv_chunk=kv_chunk, kv_valid=kv_valid,
        )
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


def _flash_attention_ranks(q, k, v, **kw):
    """``flash_attention`` on DTensors: each rank attends for its own rows of
    the batch and, over one mesh axis the batch does not take, its own
    heads, on local tensors. Attention mixes neither rows nor heads, so this
    is the one-device arithmetic per row and head; it moves K/V to every
    rank of a head group (repeated to the query heads there) and keeps
    DTensor from merging two sharded dimensions, which some torch releases
    refuse."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    h, rep = q.shape[2], q.shape[2] // k.shape[2]
    rows = [isinstance(p, Shard) and p.dim == 0 for p in q.placements]
    # the heads split over one mesh axis the rows leave free (the last whose
    # size divides them), so no dimension is split over two axes
    split = max((i for i, r in enumerate(rows) if not r and mesh.size(i) > 1 and h % mesh.size(i) == 0), default=None)
    heads = [Shard(0) if r else Shard(2) if i == split else Replicate() for i, r in enumerate(rows)]
    whole = [Shard(0) if r else Replicate() for r in rows]
    grad = [Shard(0) if r else Partial() if i == split else Replicate() for i, r in enumerate(rows)]
    ql = q.redistribute(mesh, heads).to_local()
    kl, vl = (t.redistribute(mesh, whole).to_local(grad_placements=grad).repeat_interleave(rep, dim=2) for t in (k, v))
    if split is not None:  # this rank's heads
        n = h // mesh.size(split)
        at = mesh.get_local_rank(split) * n
        kl, vl = kl.narrow(2, at, n), vl.narrow(2, at, n)
    return DTensor.from_local(flash_attention(ql, kl, vl, **kw), mesh, heads)


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
    if is_dtensor(cache_k):
        return _decode_attention_ranks(q, cache_k, cache_v, length, window=window, is_global=is_global)
    return _decode(q, cache_k, cache_v, length, window=window, is_global=is_global)


def _decode(q, cache_k, cache_v, length, *, window, is_global, start: int = 0, reduce=None):
    """``decode_attention`` over the cache slots ``start`` onwards that
    ``cache_k``/``cache_v`` hold; ``reduce(t, op)`` ("max" or "sum")
    combines a partial result in place with the ranks holding the others."""
    b, _, h, hd = q.shape
    s_len, kv = cache_k.shape[1], cache_k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(hd)
    cdt = q.dtype
    dev = q.device
    qg = (q * scalar(scale, cdt)).reshape(b, 1, kv, rep, hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), cache_k.to(cdt).float())
    k_pos = start + torch.arange(s_len, dtype=torch.int32, device=dev)
    mask = k_pos < length
    if window:
        in_win = (length - 1 - k_pos) < window
        if is_global is None:
            mask = mask & in_win
        else:
            mask = mask & (in_win | torch.as_tensor(is_global, dtype=torch.bool, device=dev))
    s = torch.where(mask[None, None, None, None], s, _NEG)
    if reduce is None:
        p = torch.softmax(s, dim=-1)
    else:  # the softmax over every rank's slots: the max and the normaliser reduced
        e = torch.exp(s - reduce(s.amax(dim=-1, keepdim=True), "max"))
        p = e / reduce(e.sum(dim=-1, keepdim=True), "sum")
    out = torch.einsum("bkrqs,bskd->bkrqd", p.to(cdt).float(), cache_v.to(cdt).float())
    if reduce is not None:
        out = reduce(out, "sum")
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd)
    return out.to(cdt)


def _decode_attention_ranks(q, cache_k, cache_v, length, *, window, is_global):
    """``decode_attention`` on a DTensor cache (batch and sequence sharded,
    ``launch.sharding.cache_spec``): each rank scores its rows against its
    slots, and the softmax and the weighted sum are reduced over the ranks
    that share its rows. A decode step has no gradient, so plain
    collectives do it."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache_k.device_mesh
    seq = [isinstance(p, Shard) and p.dim == 1 for p in cache_k.placements]
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in cache_k.placements]
    held = [Shard(1) if s else r for s, r in zip(seq, rows)]
    kl, vl = (t.redistribute(mesh, held).to_local() for t in (cache_k, cache_v))
    groups = [mesh.get_group(i) for i, s in enumerate(seq) if s]

    def reduce(t, op):
        for group in groups:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=group)
        return t

    out = _decode(
        q.redistribute(mesh, rows).to_local(), kl, vl, length, window=window, is_global=is_global,
        start=shard_span(cache_k, 1)[0], reduce=reduce if groups else None,
    )
    return DTensor.from_local(out, mesh, rows)
