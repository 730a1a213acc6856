"""Model facade: parameter init, loss, prefill/decode steps, cache init.

Port of ``repro/models/model.py``. Parameters are a nested dict of tensors
(``param_shapes`` gives the tree; layer stacks carry a leading layer axis).
``abstract_params`` and ``abstract_cache`` are the same trees on torch's
``meta`` device, so a 314B-parameter config is described without
allocating a byte. ``LM`` holds the same tree as an ``nn.Module`` whose
``state_dict()`` keys are the reference's parameter paths.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch._device import resolve

from . import ssm as ssm_lib
from . import transformer
from .layers import softmax_cross_entropy
from .transformer import Cache

__all__ = [
    "LM",
    "param_shapes",
    "init_params",
    "abstract_params",
    "cache_shapes",
    "init_cache",
    "abstract_cache",
    "train_loss",
    "prefill",
    "decode_step",
]

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def _attn_layer_shapes(cfg):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "ln1": (d,),
        "ln2": (d,),
        "wq": (d, h * hd),
        "wk": (d, kv * hd),
        "wv": (d, kv * hd),
        "wo": (h * hd, d),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)})
    return shapes


def _ffn_shapes(cfg):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.num_experts:
        e = cfg.num_experts
        shapes = {
            "router": (d, e),
            "w_gate": (e, d, f),
            "w_up": (e, d, f),
            "w_down": (e, f, d),
        }
        if cfg.dense_residual:
            shapes.update({"wr_gate": (d, f), "wr_up": (d, f), "wr_down": (f, d)})
        return shapes
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def _ssm_layer_shapes(cfg):
    dims = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv)
    return {
        "ln1": (cfg.d_model,),
        "in_proj": (cfg.d_model, dims["d_in_proj"]),
        "conv_w": (dims["conv_k"], dims["conv_dim"]),
        "conv_b": (dims["conv_dim"],),
        "a_log": (dims["nheads"],),
        "d_skip": (dims["nheads"],),
        "dt_bias": (dims["nheads"],),
        "norm_w": (dims["d_inner"],),
        "out_proj": (dims["d_inner"], cfg.d_model),
    }


def param_shapes(cfg) -> dict:
    """Nested dict of shapes; layer stacks carry a leading layer axis."""
    v, d, l = cfg.padded_vocab, cfg.d_model, cfg.num_layers
    out: dict[str, Any] = {"embed": (v, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (v, d)

    if cfg.family == "ssm":
        out["layers"] = {k: (l, *s) for k, s in _ssm_layer_shapes(cfg).items()}
    elif cfg.family == "hybrid":
        n_seg = l // cfg.attn_every
        out["layers"] = {
            k: (n_seg, cfg.attn_every, *s) for k, s in _ssm_layer_shapes(cfg).items()
        }
        out["shared_attn"] = {**_attn_layer_shapes(cfg), **_ffn_shapes(cfg)}
    else:
        out["layers"] = {
            k: (l, *s)
            for k, s in {**_attn_layer_shapes(cfg), **_ffn_shapes(cfg)}.items()
        }
    return out


def _map_shapes(fn, tree):
    """``tree`` with every shape tuple replaced by ``fn(name, shape)``, in
    sorted key order (the reference's tree-flatten order)."""
    return {
        k: _map_shapes(fn, v) if isinstance(v, dict) else fn(k, v)
        for k, v in sorted(tree.items())
    }


def _init_leaf(name: str, shape: tuple, cfg, generator, device) -> torch.Tensor:
    """The reference's init rule for one leaf (``model.py:105-129``)."""
    pdt = cfg.param_dtype
    if any(t in name for t in ("ln1", "ln2", "final_norm", "norm_w")):
        return torch.zeros(shape, dtype=pdt, device=device)
    if "dt_bias" in name:
        return torch.full(shape, math.log(math.expm1(0.01)), dtype=torch.float32, device=device).to(pdt)
    if "a_log" in name:
        return torch.zeros(shape, dtype=pdt, device=device)  # log(1)
    if "d_skip" in name:
        return torch.ones(shape, dtype=pdt, device=device)
    if name.startswith("b") or "conv_b" in name:
        return torch.zeros(shape, dtype=pdt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 0.02 if "embed" in name or "lm_head" in name else fan_in**-0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(std).to(pdt)


def init_params(cfg, *, generator: torch.Generator | None = None, device=None) -> dict:
    """Random parameters by the reference's rules: norms, biases and
    ``a_log`` zero, ``d_skip`` one, ``dt_bias`` softplus^-1(0.01), weights
    normal with std 0.02 (embeddings) or ``fan_in ** -0.5``, drawn from
    ``generator`` (on ``device``) leaf after leaf in sorted path order."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _map_shapes(lambda n, s: _init_leaf(n, s, cfg, generator, dev), param_shapes(cfg))


def abstract_params(cfg) -> dict:
    """The parameter tree on the ``meta`` device (shapes and dtypes only)."""
    return _map_shapes(
        lambda n, s: torch.empty(s, dtype=cfg.param_dtype, device="meta"), param_shapes(cfg)
    )


def cache_shapes(cfg, batch: int, capacity: int) -> dict:
    """Shapes of the decode cache for a given batch/capacity."""
    out = {}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        a = cfg.num_layers
    elif cfg.family == "hybrid":
        a = cfg.num_layers // cfg.attn_every
    else:
        a = 0
    if a:
        kvshape = (a, batch, capacity, cfg.num_kv_heads, cfg.head_dim)
        out["k"] = kvshape
        out["v"] = kvshape
    if cfg.family in ("ssm", "hybrid"):
        dims = ssm_lib.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv)
        m = cfg.num_layers
        out["conv"] = (m, batch, dims["conv_k"] - 1, dims["conv_dim"])
        out["ssd"] = (m, batch, dims["nheads"], dims["headdim"], dims["state"])
    return out


def _cache_dtype(cfg, name: str) -> torch.dtype:
    return torch.float32 if name == "ssd" else cfg.dtype


def init_cache(cfg, batch: int, capacity: int, length: int = 0, *, device=None) -> Cache:
    dev = resolve(device)
    kw = {
        k: torch.zeros(s, dtype=_cache_dtype(cfg, k), device=dev)
        for k, s in cache_shapes(cfg, batch, capacity).items()
    }
    return Cache(length=length, **kw)


def abstract_cache(cfg, batch: int, capacity: int) -> Cache:
    """The cache on ``meta``; ``length`` is a () int32 meta tensor."""
    kw = {
        k: torch.empty(s, dtype=_cache_dtype(cfg, k), device="meta")
        for k, s in cache_shapes(cfg, batch, capacity).items()
    }
    return Cache(length=torch.empty((), dtype=torch.int32, device="meta"), **kw)


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------


def train_loss(params, batch, cfg):
    """batch: {tokens|embeds: (B, L[, D]), labels: (B, L)} -> scalar loss."""
    inputs = batch["embeds"] if cfg.embeds_input else batch["tokens"]
    logits, aux, _ = transformer.forward(params, inputs, cfg, mode="train")
    loss = softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return loss + AUX_WEIGHT * aux


@torch.no_grad()
def prefill(params, inputs, cfg):
    """Full-sequence forward building a decode cache. Returns (logits, cache)."""
    logits, _, cache = transformer.forward(params, inputs, cfg, mode="prefill")
    return logits, cache


@torch.no_grad()
def decode_step(params, token, cache, cfg):
    """One decode step. token: (B, 1) int. Returns (logits, cache): the
    cache's tensors are updated in place; raises ``ValueError`` when the
    cache is full."""
    logits, _, cache = transformer.forward(params, token, cfg, mode="decode", cache=cache)
    return logits, cache


class LM(nn.Module):
    """The parameter tree as a module: ``state_dict()`` keys are the
    reference's paths (``embed``, ``layers.wq``, ``shared_attn.router``, ...).
    The functions above stay the interface; ``params()`` hands them the
    tree."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        for k, v in params.items():
            if isinstance(v, dict):
                self.add_module(k, nn.ParameterDict({n: nn.Parameter(t) for n, t in v.items()}))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def params(self) -> dict:
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        for k, m in self.named_children():
            out[k] = dict(m.items())
        return out

    def forward(self, inputs, *, mode: str = "train", cache: Cache | None = None):
        return transformer.forward(self.params(), inputs, self.cfg, mode=mode, cache=cache)
