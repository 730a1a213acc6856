"""Mixture-of-Experts: token-choice top-k routing with capacity, GShard-style.

Port of ``repro/models/moe.py``. Tokens are split into G groups, each
routes its own tokens into per-group expert capacity C_g, and the expert
FFN runs as a batched (G, E, C_g) product. The reference's sharding
arguments (``group_axes``, ``ep_axis``, ``cap_axis``) place groups and
experts on a mesh; this one-device port takes none of them.

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
) -> MoEOutput:
    t, d = x.shape
    e = router_w.shape[1]
    g = num_groups if (num_groups and t % num_groups == 0) else 1
    tg = t // g
    cap = max(int(capacity_factor * top_k * tg / e), top_k, 1)
    tk = tg * top_k
    dev = x.device

    xg = x.reshape(g, tg, d)
    r = route(xg, router_w, top_k=top_k, cap=cap)

    # Switch-style aux loss: E * sum_e fraction_routed_e * mean_prob_e.
    fe = F.one_hot(r.expert[:, :, 0], e).sum(dim=1).float() / tg  # (G, E)
    pe = r.probs.mean(dim=1)
    aux = e * (fe * pe).sum(dim=-1)  # (G,)

    # dispatch: (G, E, C + 1, D); slot C takes the dropped assignments
    flat_e = r.expert.reshape(g, tk)
    gi = torch.arange(g, device=dev)[:, None]
    tok_id = torch.arange(tg, device=dev).repeat_interleave(top_k)  # (TK,)
    src = torch.where(r.keep[..., None], xg[:, tok_id], 0).to(x.dtype)
    xin = torch.zeros((g, e, cap + 1, d), dtype=x.dtype, device=dev)
    xin[gi, flat_e, r.slot] = src
    xin = xin[:, :, :cap]

    # expert FFN (batched over groups and experts)
    g_act = torch.einsum("gecd,edf->gecf", xin, w_gate.to(x.dtype))
    u_act = torch.einsum("gecd,edf->gecf", xin, w_up.to(x.dtype))
    yout = torch.einsum("gecf,efd->gecd", F.silu(g_act) * u_act, w_down.to(x.dtype))

    # combine
    gathered = yout[gi, flat_e, torch.clamp(r.slot, 0, cap - 1)]  # (G, TK, D)
    w = torch.where(r.keep, r.gate.reshape(g, tk), 0.0).to(x.dtype)
    y = (gathered * w[..., None]).reshape(g, tg, top_k, d).sum(dim=2)

    dropped = 1.0 - r.keep.float().mean()
    return MoEOutput(y=y.reshape(t, d), aux_loss=aux.mean(), dropped_frac=dropped)
