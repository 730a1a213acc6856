"""repro_torch.optim — AdamW (+fp32 master), schedules, gradient compression."""

from . import adamw, compress
from .adamw import AdamWState, cosine_schedule

__all__ = ["adamw", "compress", "AdamWState", "cosine_schedule"]
