"""AdamW with fp32 master weights, global-norm clipping, cosine schedule.

Port of ``repro/optim/adamw.py``: the reference's arithmetic, leaf by leaf
(``torch.optim.AdamW`` is a different update). Mixed-precision contract:
model params live in ``param_dtype`` (bf16 at full width); the optimizer
holds the fp32 master copy plus two fp32 moments. The state is a tree of
tensors and ``update`` is functional: it returns new tensors and leaves the
ones it was given as they were.

A gradient leaf may be ``None``, as autograd gives one for a parameter the
loss never reads (``jax.value_and_grad`` gives zeros there): it counts as
zeros, in the norm and in the update, so the leaf still decays.

On a mesh of ranks (``train.steps``) the leaves are DTensors: the fp32
master and the moments are laid out as their param, and the update runs
leafwise on the local shards.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch._dtensor import is_dtensor
from repro_torch._tree import leaves, tree_map

__all__ = ["AdamWState", "init", "update", "cosine_schedule", "global_norm"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    master: Any  # fp32 params
    mu: Any
    nu: Any


def _zeros(p) -> torch.Tensor:
    """float32 zeros shaped as ``p``; laid out as ``p`` when it is a DTensor."""
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params) -> AdamWState:
    """Step 0 (an int32 0-d tensor on the params' device), the fp32 master
    copy and zero moments, each laid out as its param (a DTensor's shards
    stay on their ranks)."""
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        mu=tree_map(_zeros, params),
        nu=tree_map(_zeros, params),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, summed in the
    reference's leaf order; ``None`` leaves add nothing. On DTensor leaves
    each sum is a partial one per rank, and the sqrt reduces them over every
    shard first: one norm, alike on every rank, scales every leaf."""
    parts = [torch.sum(torch.square(l.float())) for l in leaves(tree)]
    return torch.sqrt(sum(parts[1:], parts[0]))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """``lr(step)``: linear warmup, then a cosine to 0 at ``total``; a
    function of a step tensor, computed in float32."""

    def lr(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def update(
    grads,
    state: AdamWState,
    *,
    lr_fn,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    param_dtype=torch.bfloat16,
):
    """One AdamW step. Returns (new model params, new state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_fn(step)
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = torch.zeros_like(p) if g is None else g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        return m, v, p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

    out = tree_map(upd, state.master, grads, state.mu, state.nu)  # a (m, v, p) per leaf
    mu, nu, master = (tree_map(lambda _, t: t[i], state.master, out) for i in range(3))
    # copy=True: with param_dtype float32 the cast is the identity, and the
    # returned params would share storage with the master (the reference's
    # optimization_barrier keeps XLA from aliasing them).
    params = tree_map(lambda p: p.to(param_dtype, copy=True), master)
    new_state = AdamWState(step=step, master=master, mu=mu, nu=nu)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
