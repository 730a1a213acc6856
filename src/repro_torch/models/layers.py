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

On a mesh of ranks (DTensor params and activations) ``embed``,
``unembed`` and ``softmax_cross_entropy`` run on local tensors: each rank
looks up and projects its own rows (the unembedding onto its slice of the
vocab), and the loss reduces the log-sum-exp, the gold logit and the mean
over the ranks (DTensor's ``gather`` of sharded logits is not supported).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch._dtensor import is_dtensor, on_rows, row_placements, shard_span, sum_over

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
    """``x @ w (+ b)``. On DTensors the activations are laid out by rows
    alone before and after the product (the reference's activation
    constraints, ``_act``): every activation and its gradient then has one
    layout, where DTensor's own choice leaves a tensor whose gradients
    arrive in two layouts, which some torch releases cannot sum."""
    if is_dtensor(x):
        rows = row_placements(x)
        y = _product(x.redistribute(x.device_mesh, rows), w, b)
        return y.redistribute(y.device_mesh, rows)
    return _product(x, w, b)


def _product(x, w, b):
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(F.silu(g) * u, w_down)


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of ``table`` for int32 or int64 ``tokens``, cast to ``dtype``. On
    DTensors each rank looks its own rows of tokens up in the whole table
    (DTensor's indexing of a sharded table fails on some torch releases)."""
    if is_dtensor(table):
        return on_rows(lambda p, t: embed(t, p["table"], dtype), {"table": table}, tokens)
    return table[tokens.long()].to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Project to vocab logits (float32 for a stable loss/softmax)."""
    if is_dtensor(table):
        return _unembed_ranks(x, table)
    return torch.matmul(x.float(), table.float().t())


def _unembed_ranks(x, table):
    """``unembed`` on DTensors, on local tensors: each rank projects its rows
    onto its slice of the vocab (the table's vocab split as the specs split
    it, its FSDP dimension gathered), so the logits come out split by rows
    and vocab alone (DTensor's own product leaves them in layouts whose
    backward some torch releases cannot run)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    rows = row_placements(x)
    vocab = [isinstance(p, Shard) and p.dim == 0 and not isinstance(r, Shard) for p, r in zip(table.placements, rows)]
    xl = x.redistribute(mesh, rows).to_local(grad_placements=[Partial() if v else r for v, r in zip(vocab, rows)])
    tl = table.redistribute(mesh, [Shard(0) if v else Replicate() for v in vocab]).to_local(
        grad_placements=[Shard(0) if v else Partial() if isinstance(r, Shard) else Replicate() for v, r in zip(vocab, rows)]
    )
    return DTensor.from_local(torch.matmul(xl.float(), tl.float().t()), mesh, [Shard(2) if v else r for v, r in zip(vocab, rows)])


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
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels, vocab_size)
    if logits.shape[-1] > vocab_size:
        logits = logits.clone()
        logits[..., vocab_size:] = -1e30
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def _sharded_cross_entropy(logits, labels, vocab_size: int) -> torch.Tensor:
    """``softmax_cross_entropy`` on DTensor logits, on local tensors: each
    rank takes its rows and its slice of the vocab (as the logits are laid
    out), masks the padded entries alike, and the max (without gradient:
    it cancels, as in ``torch.logsumexp``), the sum of exponentials, the
    gold logit and the mean are reduced over the ranks holding the rest. A
    plain scalar, alike on every rank (DTensor's arithmetic on such scalars
    fails on some torch releases)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    mesh = logits.device_mesh
    rows = row_placements(logits)
    vocab = [i for i, p in enumerate(logits.placements) if isinstance(p, Shard) and p.dim == 2]
    mine = logits.redistribute(mesh, [Shard(2) if i in vocab else r for i, r in enumerate(rows)])
    start, stop = shard_span(mine, 2)
    ll = mine.to_local()
    ids = torch.arange(start, stop, device=ll.device)
    if logits.shape[-1] > vocab_size:
        ll = torch.where(ids < vocab_size, ll, -1e30)
    m = ll.detach().amax(dim=-1, keepdim=True)
    for i in vocab:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    lab = labels.redistribute(mesh, rows).to_local().long()
    logz = torch.log(sum_over(torch.exp(ll - m).sum(dim=-1), mesh, vocab)) + m[..., 0]
    gold = sum_over(torch.where(ids == lab[..., None], ll, 0.0).sum(dim=-1), mesh, vocab)
    split = [i for i, r in enumerate(rows) if isinstance(r, Shard)]
    return sum_over((logz - gold).sum(), mesh, split) / (logits.shape[0] * logits.shape[1])
