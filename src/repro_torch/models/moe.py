"""Mixture-of-Experts: token-choice top-k routing with capacity, GShard-style.

Port of ``repro/models/moe.py``. Tokens are split into G groups, each
routes its own tokens into per-group expert capacity C_g, and the expert
FFN runs as a batched (G, E, C_g) product. The reference's sharding
arguments (``group_axes``, ``ep_axis``, ``cap_axis``) place groups and
experts on a mesh. On plain tensors this port takes none of them. On
DTensors (a mesh of ranks) it takes ``group_axes``: each rank routes its
own groups on local tensors, since DTensor does not shard the routing's
``scatter_add_``, ``argsort`` and ``scatter_``, and multiplies them by its
shard of the expert weights as the specs shard them (the expert dimension
over ``model`` when it divides, else F).

Slots: a **stable** argsort of the chosen experts gives every assignment
its position in its expert's queue (earlier tokens win); an assignment at
position >= C_g is dropped. The reference scatters with
``.at[...].set(mode="drop")``, which discards the out-of-range writes;
torch index writes raise on them instead, so the dispatch buffer has one
spare slot per expert that takes every dropped assignment and is then cut
off. The (tokens, experts, capacity) one-hot is never built.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch._dtensor import is_dtensor, sum_over, whole

__all__ = ["moe_ffn", "MoEOutput", "route"]


class MoEOutput(NamedTuple):
    y: torch.Tensor  # (T, D)
    aux_loss: torch.Tensor  # () switch-style load-balance loss
    dropped_frac: torch.Tensor  # () fraction of routed assignments dropped


class Routing(NamedTuple):
    probs: torch.Tensor  # (G, Tg, E) float32 router softmax
    gate: torch.Tensor  # (G, Tg, k) renormalised top-k weights
    expert: torch.Tensor  # (G, Tg, k) chosen experts (int64)
    slot: torch.Tensor  # (G, Tg * k) position in the expert's buffer; cap when dropped
    keep: torch.Tensor  # (G, Tg * k) bool


def route(xg: torch.Tensor, router_w: torch.Tensor, *, top_k: int, cap: int) -> Routing:
    """Top-k over the float32 softmax (renormalised), then capacity slots."""
    g, tg, _ = xg.shape
    tk = tg * top_k
    dev = xg.device
    logits = torch.einsum("gtd,de->gte", xg.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, top_k, dim=-1)  # (G, Tg, k)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)

    flat_e = expert.reshape(g, tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    counts = torch.zeros((g, router_w.shape[1]), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=-1) - counts  # exclusive prefix (G, E)
    sorted_e = torch.gather(flat_e, 1, order)
    pos_sorted = torch.arange(tk, device=dev)[None, :] - torch.gather(starts, 1, sorted_e)
    pos = torch.zeros((g, tk), dtype=torch.int64, device=dev).scatter_(1, order, pos_sorted)
    keep = pos < cap
    slot = torch.where(keep, pos, cap)
    return Routing(probs, gate, expert, slot, keep)


def moe_ffn(
    x: torch.Tensor,  # (T, D) token embeddings (flattened batch*seq)
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    num_groups: int = 1,
    group_axes: tuple = (),
) -> MoEOutput:
    """``group_axes``: the mesh axes the groups shard over on a mesh of
    ranks (the reference's argument); a plain tensor ignores it."""
    t, d = x.shape
    e = router_w.shape[1]
    g = num_groups if (num_groups and t % num_groups == 0) else 1
    tg = t // g
    cap = max(int(capacity_factor * top_k * tg / e), top_k, 1)
    if is_dtensor(x):
        return _moe_ffn_ranks(x, router_w, w_gate, w_up, w_down, top_k=top_k, g=g, cap=cap, group_axes=group_axes)
    xg = x.reshape(g, tg, d)
    r = route(xg, router_w, top_k=top_k, cap=cap)
    aux = _aux(r, e, tg)
    y = _combine(_ffn(_dispatch(xg, r, e, cap), w_gate, w_up, w_down, x.dtype), r, cap)
    dropped = 1.0 - r.keep.float().mean()
    return MoEOutput(y=y.reshape(t, d), aux_loss=aux.mean(), dropped_frac=dropped)


def _aux(r: Routing, e: int, tg: int) -> torch.Tensor:
    """Switch-style aux loss per group: E * sum_e fraction_routed_e * mean_prob_e."""
    fe = F.one_hot(r.expert[:, :, 0], e).sum(dim=1).float() / tg  # (G, E)
    pe = r.probs.mean(dim=1)
    return e * (fe * pe).sum(dim=-1)  # (G,)


def _dispatch(xg: torch.Tensor, r: Routing, e: int, cap: int) -> torch.Tensor:
    """(G, E, C, D) expert inputs; slot C takes the dropped assignments and
    is cut off."""
    g, tg, d = xg.shape
    top_k = r.expert.shape[-1]
    dev = xg.device
    gi = torch.arange(g, device=dev)[:, None]
    tok_id = torch.arange(tg, device=dev).repeat_interleave(top_k)  # (TK,)
    src = torch.where(r.keep[..., None], xg[:, tok_id], 0).to(xg.dtype)
    xin = torch.zeros((g, e, cap + 1, d), dtype=xg.dtype, device=dev)
    xin[gi, r.expert.reshape(g, tg * top_k), r.slot] = src
    return xin[:, :, :cap]


def _ffn(xin, w_gate, w_up, w_down, dtype) -> torch.Tensor:
    """The expert FFN, batched over groups and experts."""
    g_act = torch.einsum("gecd,edf->gecf", xin, w_gate.to(dtype))
    u_act = torch.einsum("gecd,edf->gecf", xin, w_up.to(dtype))
    return torch.einsum("gecf,efd->gecd", F.silu(g_act) * u_act, w_down.to(dtype))


def _combine(yout: torch.Tensor, r: Routing, cap: int) -> torch.Tensor:
    """(G, Tg, D): each token's kept assignments, weighted by their gates."""
    g, tg, top_k = r.expert.shape
    gi = torch.arange(g, device=yout.device)[:, None]
    gathered = yout[gi, r.expert.reshape(g, tg * top_k), torch.clamp(r.slot, 0, cap - 1)]  # (G, TK, D)
    w = torch.where(r.keep, r.gate.reshape(g, tg * top_k), 0.0).to(yout.dtype)
    return (gathered * w[..., None]).reshape(g, tg, top_k, -1).sum(dim=2)


def _moe_ffn_ranks(x, router_w, w_gate, w_up, w_down, *, top_k: int, g: int, cap: int, group_axes) -> MoEOutput:
    """``moe_ffn`` on DTensors. Routing and the dispatch/combine scatters
    (which DTensor does not shard) run on local tensors: each rank holds
    whole groups of tokens (the groups sharded over ``group_axes`` when
    their count divides, else every group on every rank) and routes them
    with the whole router; ``_experts_on_shards`` runs the expert
    products. The aux loss and the dropped fraction are plain scalars,
    alike on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    t, d = x.shape
    e = router_w.shape[1]
    split = [g > 1 and name in group_axes for name in mesh.mesh_dim_names]
    shards = 1
    for i, s in enumerate(split):
        shards *= mesh.size(i) if s else 1
    if g % shards:
        split, shards = [False] * len(split), 1
    tok = [Shard(0) if s else Replicate() for s in split]
    gl, tg = g // shards, t // g

    xg = x.redistribute(mesh, tok).to_local().reshape(gl, tg, d)
    r = route(xg, whole(router_w, tok), top_k=top_k, cap=cap)
    xin = DTensor.from_local(_dispatch(xg, r, e, cap), mesh, tok)
    yout = _experts_on_shards(xin, w_gate, w_up, w_down, split).redistribute(mesh, tok).to_local()
    y = DTensor.from_local(_combine(yout, r, cap).reshape(gl * tg, d), mesh, tok)
    over = [i for i, s in enumerate(split) if s]  # the ranks holding the other groups
    aux = sum_over(_aux(r, e, tg).sum(), mesh, over) / g
    dropped = 1.0 - sum_over(r.keep.float().sum(), mesh, over) / (g * tg * top_k)
    return MoEOutput(y=y, aux_loss=aux, dropped_frac=dropped)


def _experts_on_shards(xin, w_gate, w_up, w_down, split):
    """The expert FFN of ``_moe_ffn_ranks`` on local shards: each rank
    multiplies its groups' buffers (``xin``, (G, E, C, D), the groups
    sharded where ``split`` says) by its experts' weights, or by its slice
    of F, as the weights' specs shard them over the mesh, with their FSDP
    dimension gathered. Returns (G, E, C, D) as a DTensor: experts sharded,
    F slices partial sums. Local products keep DTensor from merging two
    sharded dimensions, which some torch releases refuse."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = xin.device_mesh
    ep = [isinstance(p, Shard) and p.dim == 0 for p in w_gate.placements]  # experts over this axis
    tp = [isinstance(p, Shard) and p.dim == 2 for p in w_gate.placements]  # F over this axis
    if any(s and (e or t) for s, e, t in zip(split, ep, tp)):
        raise ValueError("an MoE layer's groups and its experts (or F) shard over the same mesh axis")

    def local(w, f_dim):
        pl = [Shard(0) if e else Shard(f_dim) if t else Replicate() for e, t in zip(ep, tp)]
        grad = [p if e or t else Partial() if s else Replicate() for p, e, t, s in zip(pl, ep, tp, split)]
        return w.redistribute(mesh, pl).to_local(grad_placements=grad)

    x_pl = [Shard(0) if s else Shard(1) if e else Replicate() for s, e in zip(split, ep)]
    x_grad = [Partial() if t else p for p, t in zip(x_pl, tp)]
    xl = xin.redistribute(mesh, x_pl).to_local(grad_placements=x_grad)
    yl = _ffn(xl, local(w_gate, 2), local(w_up, 2), local(w_down, 1), xl.dtype)
    y_pl = [Shard(0) if s else Shard(1) if e else Partial() if t else Replicate() for s, e, t in zip(split, ep, tp)]
    return DTensor.from_local(yl, mesh, y_pl)
