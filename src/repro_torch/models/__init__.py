"""repro_torch.models — LM substrate: layers, attention, MoE, SSM, hybrid stacks."""

from . import attention, frontends, layers, model, moe, ssm, transformer
from .transformer import Cache

__all__ = [
    "attention",
    "frontends",
    "layers",
    "model",
    "moe",
    "ssm",
    "transformer",
    "Cache",
]
