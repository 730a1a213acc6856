"""Architecture registry: ``get_config("<arch-id>")`` resolves --arch flags."""

from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ShapeConfig, reduce_for_smoke

_ARCHS = {
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
    "command-r-35b": "command_r_35b",
    "granite-3-8b": "granite_3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma3-12b": "gemma3_12b",
    "internvl2-1b": "internvl2_1b",
    "mamba2-2.7b": "mamba2_2_7b",
    "musicgen-large": "musicgen_large",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")
    return mod.CONFIG


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells; long_500k runs only for the
    sub-quadratic archs (``cfg.subquadratic``)."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and not cfg.subquadratic
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name, skipped))
    return out


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "reduce_for_smoke",
    "cells",
]
