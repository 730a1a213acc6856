"""repro_torch.train — step builders + fault-tolerant runner."""

from . import runner, steps
from .steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["runner", "steps", "make_prefill_step", "make_serve_step", "make_train_step"]
