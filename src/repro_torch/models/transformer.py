"""Decoder stacks for all families.

Port of ``repro/models/transformer.py``. Per-layer parameters are stacked
on a leading layer axis, as in the reference; where the reference scans
over that axis (``lax.scan``), this module loops in Python over views of
the stacked leaves. Heterogeneous patterns:

  * gemma3 5:1 local:global — a per-layer ``is_global`` flag (bool tensor);
  * zamba2 — Mamba2 segments, the *shared* attention block (one param set)
    applied after each segment;
  * MoE — expert weights stacked (L, E, D, F), dispatched per layer.

Modes: "train"/"prefill" process full sequences (flash attention / chunked
SSD); "decode" processes one token against a cache. The reference's
sharding constraints on activations (``_act``) are the identity on one
device and are left out.

The decode cache is preallocated at its capacity, as a server's is:
``decode`` writes the token's K/V and the new SSM states into the cache's
tensors in place and returns the cache with ``length + 1``, so a cache
passed to a decode step is used up. Each cache tensor carries the length
its last decode step left it at; decoding again from a kept, earlier
``Cache`` over those tensors raises ``ValueError`` (its SSM states and K/V
slots have moved on), where the reference's functional decode would
answer from it. Writing at ``length == capacity`` raises ``ValueError``
too; the reference's ``dynamic_update_slice`` clamps that write onto the
last slot and answers wrong.

A forward runs under ``layers.reference_matmul`` (float32 accumulation of
bf16 GEMMs, no TF32). An MoE layer on a mesh (``cfg.mesh_model`` with
``cfg.mesh_axis_sizes``, set by ``train.steps``) routes each data-parallel
shard's tokens as its own group, as the reference does (``moe_groups``).

On a mesh of ranks the params and inputs are DTensors and the forward is
the same code: ``train.steps`` runs it under ``implicit_replication``, so
the positions, masks and flags made here meet the DTensors as replicated
ones. Where DTensor has no strategy, or some torch release fails, the
model computes on local shards: the embedding, the unembedding and the
loss (``models/layers.py``), attention (``models/attention.py``), an MoE
layer's routing and expert products (``models/moe.py``), the Mamba2 mixer
(``models/ssm.py``), and a decode step's writes into a sharded cache
(``_write_slot``, ``_store``).

Remat: in ``mode="train"`` with ``cfg.remat``, each layer (and each use of
zamba2's shared block) runs under ``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``: policy ``"nothing"`` keeps only the layer's
input and recomputes the rest in the backward pass; ``"dots"`` also keeps
the outputs of the products without batch dimensions (``mm``/``addmm``).
Remat changes memory, not numbers.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import attention as attn_lib
from . import moe as moe_lib
from . import ssm as ssm_lib
from repro_torch._dtensor import is_dtensor, shard_span

from .layers import dense, embed, reference_matmul, rms_norm, rope, scalar, swiglu, unembed

__all__ = ["forward", "Cache", "layer_flags"]


class Cache(NamedTuple):
    """Unified decode cache. Attention slots and/or SSM slots may be present.

    k/v: (A, B, S, KV, hd) for the A attention layers of the model
    conv/ssd: (M, B, K-1, C) / (M, B, H, P, N) for the M Mamba layers
    length: int — number of valid tokens already in the cache.
    """

    k: Any = None
    v: Any = None
    conv: Any = None
    ssd: Any = None
    length: Any = None


def layer_flags(cfg, device=None) -> torch.Tensor | None:
    """Per-layer is_global flags (gemma3 5:1 pattern); None when uniform."""
    if cfg.global_every:
        i = torch.arange(cfg.num_layers, device=device)
        return (i % cfg.global_every) == (cfg.global_every - 1)
    return None


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views of the stacked leaves."""
    return {k: v[i] for k, v in stacked.items()}


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _dots_saved():
    """Selective-checkpoint contexts that keep the products without batch
    dimensions: the reference's ``dots_with_no_batch_dims_saveable``."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts([torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _remat(fn, cfg, mode: str):
    """``fn`` under ``torch.utils.checkpoint`` when ``cfg.remat`` is on in
    train mode (the reference's ``jax.checkpoint``), else ``fn``."""
    if not (cfg.remat and mode == "train"):
        return fn
    from torch.utils.checkpoint import checkpoint

    kw = {"context_fn": _dots_saved} if cfg.remat_policy == "dots" else {}
    return lambda *args, **kwargs: checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)


# --------------------------------------------------------------------------
# sub-blocks
# --------------------------------------------------------------------------


def _attn_sublayer(p, x, cfg, *, positions, mode, is_global=None, ck=None, cv=None, length=None):
    """Attention residual branch. Returns (delta, new_k, new_v)."""
    b, l, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["ln1"])
    q = dense(xn, p["wq"], p.get("bq")).reshape(b, l, h, hd)
    k = dense(xn, p["wk"], p.get("bk")).reshape(b, l, kv, hd)
    v = dense(xn, p["wv"], p.get("bv")).reshape(b, l, kv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode == "decode":
        # insert at position `length` (checked against the capacity by
        # `forward`), then attend over length + 1 tokens
        if is_dtensor(ck):
            _write_slot(ck, k, length)
            _write_slot(cv, v, length)
        else:
            ck[:, length : length + 1] = k.to(ck.dtype)
            cv[:, length : length + 1] = v.to(cv.dtype)
        o = attn_lib.decode_attention(
            q, ck, cv, length + 1, window=cfg.sliding_window, is_global=is_global
        )
        out_k, out_v = ck, cv
    else:
        o = attn_lib.flash_attention(
            q, k, v, causal=True, window=cfg.sliding_window, is_global=is_global,
            kv_chunk=cfg.attn_kv_chunk,
        )
        out_k, out_v = k, v
    return dense(o.reshape(b, l, h * hd), p["wo"]), out_k, out_v


def _write_slot(cache_t, new, length: int) -> None:
    """``cache_t[:, length] = new[:, 0]`` for a DTensor cache (B, S, KV, hd),
    in place. DTensor does not write through a slice of a sharded
    dimension, so the write goes to the local shards: ``new`` is laid out
    as the cache is on every dimension but the sequence, and the rank whose
    sequence shard holds ``length`` writes it there."""
    from torch.distributed.tensor import Replicate, Shard

    whole_seq = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in cache_t.placements]
    local_new = new.redistribute(cache_t.device_mesh, whole_seq).to_local()
    start, stop = shard_span(cache_t, 1)
    if start <= length < stop:
        cache_t.to_local()[:, length - start] = local_new[:, 0].to(cache_t.dtype)


def _store(cache_t, i: int, new) -> None:
    """``cache_t[i] = new`` in place; into a DTensor cache through its local
    shards, ``new`` laid out as the cache's layer ``i`` is."""
    if not is_dtensor(cache_t):
        cache_t[i] = new
        return
    dst = cache_t[i]
    dst.to_local().copy_(new.redistribute(dst.device_mesh, dst.placements).to_local())


def moe_groups(cfg, tokens: int) -> int:
    """GShard groups of an MoE layer over ``tokens`` (b * l): the
    data-parallel size when the config carries a mesh with a model axis
    (``train.steps._with_mesh_axes``) and it divides the tokens, else 1."""
    sizes = dict(cfg.mesh_axis_sizes)
    if not (cfg.mesh_model and sizes):
        return 1
    dp_size = 1
    for a in cfg.mesh_dp:
        dp_size *= sizes[a]
    return dp_size if tokens % dp_size == 0 else 1


def _ff_sublayer(p, x, cfg):
    """FFN residual branch: dense SwiGLU or MoE (+optional dense residual)."""
    xn = rms_norm(x, p["ln2"])
    if cfg.num_experts:
        b, l, d = xn.shape
        out = moe_lib.moe_ffn(
            xn.reshape(b * l, d),
            p["router"], p["w_gate"], p["w_up"], p["w_down"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            num_groups=moe_groups(cfg, b * l), group_axes=tuple(cfg.mesh_dp),
        )
        y = out.y.reshape(b, l, d)
        if cfg.dense_residual:
            y = y + swiglu(xn, p["wr_gate"], p["wr_up"], p["wr_down"])
        return y, out.aux_loss
    return swiglu(xn, p["w_gate"], p["w_up"], p["w_down"]), _zero(x)


def _attn_ffn_layer(p, x, cfg, *, positions, mode, is_global=None, ck=None, cv=None, length=None):
    """One attention + FFN layer. Returns (x, aux, new_k, new_v)."""
    delta, nk, nv = _attn_sublayer(
        p, x, cfg, positions=positions, mode=mode, is_global=is_global, ck=ck, cv=cv, length=length
    )
    x = x + delta
    ff, aux = _ff_sublayer(p, x, cfg)
    return x + ff, aux, nk, nv


def _ssm_layer(lp, x, cfg, *, return_state):
    """One Mamba2 layer's residual branch (and its final state)."""
    return ssm_lib.ssm_forward(
        {k: v for k, v in lp.items() if k != "ln1"}, rms_norm(x, lp["ln1"]), cfg, return_state=return_state
    )


# --------------------------------------------------------------------------
# family forwards
# --------------------------------------------------------------------------


def _fwd_attn_stack(params, x, cfg, *, positions, mode, cache: Cache | None):
    """Dense / MoE / gemma-pattern attention stacks (one loop over layers)."""
    flags = layer_flags(cfg, x.device)
    aux = _zero(x)
    ks, vs = [], []
    layer = _remat(_attn_ffn_layer, cfg, mode)
    for i in range(cfg.num_layers):
        ck = cv = None
        if cache is not None:
            ck, cv = cache.k[i], cache.v[i]
        x, aux_l, nk, nv = layer(
            _layer(params["layers"], i), x, cfg, positions=positions, mode=mode,
            is_global=None if flags is None else flags[i],
            ck=ck, cv=cv, length=None if cache is None else cache.length,
        )
        aux = aux + aux_l
        if mode == "prefill":  # train mode keeps no K/V
            ks.append(nk)
            vs.append(nv)
    if mode == "prefill":
        return x, aux, torch.stack(ks), torch.stack(vs)
    if mode == "decode":
        return x, aux, cache.k, cache.v
    return x, aux, None, None


def _fwd_ssm_stack(params, x, cfg, *, mode, cache: Cache | None):
    """Pure Mamba2 stack (mamba2-2.7b)."""
    n_l = next(iter(params["layers"].values())).shape[0]
    if mode == "decode":
        for i in range(n_l):
            lp = _layer(params["layers"], i)
            delta, st = ssm_lib.ssm_decode_step(
                {k: v for k, v in lp.items() if k != "ln1"},
                rms_norm(x[:, 0], lp["ln1"]), ssm_lib.SSMState(cache.conv[i], cache.ssd[i]), cfg,
            )
            _store(cache.conv, i, st.conv)
            _store(cache.ssd, i, st.ssd)
            x = x + delta[:, None]
        return x, _zero(x), cache.conv, cache.ssd

    convs, ssds = [], []
    layer = _remat(_ssm_layer, cfg, mode)
    for i in range(n_l):
        out = layer(_layer(params["layers"], i), x, cfg, return_state=(mode == "prefill"))
        if mode == "prefill":
            delta, st = out
            convs.append(st.conv)
            ssds.append(st.ssd)
        else:
            delta = out
        x = x + delta
    if mode == "prefill":
        return x, _zero(x), torch.stack(convs), torch.stack(ssds)
    return x, _zero(x), None, None


def _fwd_hybrid(params, x, cfg, *, positions, mode, cache: Cache | None):
    """Zamba2: Mamba2 segments + ONE shared attention block after each."""
    every = cfg.attn_every
    n_seg = cfg.num_layers // every
    sp = params["shared_attn"]

    new_convs, new_ssds, new_ks, new_vs = [], [], [], []
    aux = _zero(x)
    block = _remat(_attn_ffn_layer, cfg, mode)  # the shared block, checkpointed at each use
    for s in range(n_seg):
        lp_seg = _layer(params["layers"], s)
        sub_cache = None
        if cache is not None and mode == "decode":
            sub_cache = Cache(
                conv=cache.conv[s * every : (s + 1) * every],
                ssd=cache.ssd[s * every : (s + 1) * every],
                length=cache.length,
            )
        ck = cache.k[s] if (cache is not None and cache.k is not None) else None
        cv = cache.v[s] if (cache is not None and cache.v is not None) else None

        x, _, conv_s, ssd_s = _fwd_ssm_stack({"layers": lp_seg}, x, cfg, mode=mode, cache=sub_cache)
        x, aux_l, nk, nv = block(
            sp, x, cfg, positions=positions, mode=mode,
            ck=ck, cv=cv, length=None if cache is None else cache.length,
        )
        aux = aux + aux_l
        if mode == "prefill":
            new_convs.append(conv_s)
            new_ssds.append(ssd_s)
            new_ks.append(nk)
            new_vs.append(nv)

    if mode == "prefill":
        return (x, aux, torch.stack(new_ks), torch.stack(new_vs),
                torch.cat(new_convs), torch.cat(new_ssds))
    if mode == "decode":
        return x, aux, cache.k, cache.v, cache.conv, cache.ssd
    return x, aux, None, None, None, None


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------


_DECODED_TO = "_repro_decoded_to"  # the length a decode step left a cache tensor at


def _claim(cache: Cache) -> None:
    """Check that ``cache`` may take a decode step, then mark its tensors as
    advanced to ``length + 1``: raises at capacity, and for a cache whose
    tensors a later step has already moved on. A cache on ``meta`` (the
    dry run's) keeps its length on the host, a Python int."""
    if isinstance(cache.length, torch.Tensor) and cache.length.device.type == "meta":
        raise ValueError(
            "a cache on meta takes a decode step with its length on the host: "
            "cache._replace(length=<int below the capacity>)"
        )
    length = int(cache.length)
    if cache.k is not None and length >= cache.k.shape[2]:
        raise ValueError(
            f"decode past the cache: length {length} == capacity {cache.k.shape[2]}; "
            "prefill with cfg.cache_pad at least the decode budget"
        )
    tensors = [t for t in (cache.k, cache.v, cache.conv, cache.ssd) if t is not None]
    for t in tensors:
        at = getattr(t, _DECODED_TO, length)
        if at != length:
            raise ValueError(
                f"stale cache: it says length {length}, but a decode step from it already "
                f"moved its tensors to {at}; a cache is used once (decode from the returned one)"
            )
    for t in tensors:
        setattr(t, _DECODED_TO, length + 1)


def forward(params, inputs, cfg, *, mode: str, cache: Cache | None = None):
    """Run the stack.

    inputs: int tokens (B, L), int32 or int64, or precomputed embeddings
    (B, L, D) for the stubbed [vlm]/[audio] frontends. Returns
    (logits_f32, aux_loss, Cache | None).
    """
    if mode == "decode":
        _claim(cache)
    with reference_matmul():
        return _forward(params, inputs, cfg, mode=mode, cache=cache)


def _forward(params, inputs, cfg, *, mode, cache):
    if not inputs.is_floating_point():
        x = embed(inputs, params["embed"], cfg.dtype)
        if cfg.scale_embed:
            x = x * scalar(cfg.d_model**0.5, cfg.dtype)
    else:
        x = inputs.to(cfg.dtype)
    b, l = x.shape[0], x.shape[1]

    if mode == "decode":
        positions = torch.full((b, 1), cache.length, dtype=torch.int32, device=x.device)
    else:
        positions = torch.arange(l, dtype=torch.int32, device=x.device).expand(b, l)

    family = cfg.family
    new_cache = None
    if family in ("dense", "moe", "vlm", "audio"):
        x, aux, ks, vs = _fwd_attn_stack(params, x, cfg, positions=positions, mode=mode, cache=cache)
        if mode == "prefill":
            new_cache = _prefill_attn_cache(ks, vs, cfg, b, l)
        elif mode == "decode":
            new_cache = cache._replace(k=ks, v=vs, length=cache.length + 1)
    elif family == "ssm":
        x, aux, convs, ssds = _fwd_ssm_stack(params, x, cfg, mode=mode, cache=cache)
        if mode == "prefill":
            new_cache = Cache(conv=convs, ssd=ssds, length=l)
        elif mode == "decode":
            new_cache = cache._replace(conv=convs, ssd=ssds, length=cache.length + 1)
    elif family == "hybrid":
        x, aux, ks, vs, convs, ssds = _fwd_hybrid(
            params, x, cfg, positions=positions, mode=mode, cache=cache
        )
        if mode == "prefill":
            kc = _prefill_attn_cache(ks, vs, cfg, b, l)
            new_cache = Cache(k=kc.k, v=kc.v, conv=convs, ssd=ssds, length=l)
        elif mode == "decode":
            new_cache = cache._replace(k=ks, v=vs, conv=convs, ssd=ssds, length=cache.length + 1)
    else:
        raise ValueError(f"unknown family {family}")

    x = rms_norm(x, params["final_norm"])
    if mode in ("prefill", "decode"):
        x = x[:, -1:]  # only the last position produces a next-token logit
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, table), aux, new_cache


def _prefill_attn_cache(ks, vs, cfg, b, l) -> Cache:
    """Stacked per-layer K/V from prefill become the decode cache, padded
    by ``cfg.cache_pad`` slots (the decode budget)."""
    pad = cfg.cache_pad
    if pad:
        ks, vs = _pad_seq(ks, pad), _pad_seq(vs, pad)
    return Cache(k=ks, v=vs, length=l)


def _pad_seq(t, pad: int):
    """``pad`` zero slots after the sequence dimension of stacked K/V (A, B,
    S, KV, hd); a DTensor is padded on its local shards, the sequence
    gathered first where a mesh axis shards it (DTensor's own pad fails on
    some torch releases)."""
    if not is_dtensor(t):
        return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
    from torch.distributed.tensor import DTensor, Replicate, Shard

    whole_seq = [Replicate() if isinstance(p, Shard) and p.dim == 2 else p for p in t.placements]
    t = t.redistribute(t.device_mesh, whole_seq)
    return DTensor.from_local(torch.nn.functional.pad(t.to_local(), (0, 0, 0, 0, 0, pad)), t.device_mesh, whole_seq)
