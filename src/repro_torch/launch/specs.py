"""Input stand-ins on torch's ``meta`` device for every (arch × shape) cell.

Port of ``repro/launch/specs.py``: the same trees as the reference's
``ShapeDtypeStruct``s, as meta tensors (shapes and dtypes, no bytes).
"""

from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.models import model as model_lib

__all__ = ["input_specs", "input_specs_for", "model_flops", "shape_config"]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str) -> dict:
    """Stand-ins for one cell: params/batch (train), params/inputs
    (prefill) or params/token/cache (decode)."""
    return input_specs_for(get_config(arch), shape_name)


def shape_config(shape_name) -> ShapeConfig:
    """The ``ShapeConfig`` a name of ``SHAPES`` names; a ``ShapeConfig`` of
    one's own stands for itself."""
    return SHAPES[shape_name] if isinstance(shape_name, str) else shape_name


def input_specs_for(cfg, shape_name) -> dict:
    """Same, for an arbitrary (possibly variant) ModelConfig; ``shape_name``
    may also be a ``ShapeConfig`` of its own."""
    shape = shape_config(shape_name)
    b, s = shape.global_batch, shape.seq_len
    params = model_lib.abstract_params(cfg)

    if shape.kind == "train":
        batch = {"labels": _spec((b, s), torch.int32)}
        if cfg.embeds_input:
            batch["embeds"] = _spec((b, s, cfg.d_model), cfg.dtype)
        else:
            batch["tokens"] = _spec((b, s), torch.int32)
        return {"params": params, "batch": batch}

    if shape.kind == "prefill":
        if cfg.embeds_input:
            inputs = _spec((b, s, cfg.d_model), cfg.dtype)
        else:
            inputs = _spec((b, s), torch.int32)
        return {"params": params, "inputs": inputs}

    # decode: one new token against a seq_len cache
    cache = model_lib.abstract_cache(cfg, b, s)
    return {"params": params, "token": _spec((b, 1), torch.int32), "cache": cache}


def model_flops(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS for the usefulness ratio: 6·N·D train, 2·N·D inference
    (N = active params for MoE, D = processed tokens)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token per seq
