"""repro_torch.checkpoint — atomic, optionally async checkpoints of tensor trees."""

from .store import (
    latest_step,
    load_snapshot,
    restore,
    save,
    save_snapshot,
    wait_pending,
)

__all__ = [
    "latest_step",
    "load_snapshot",
    "restore",
    "save",
    "save_snapshot",
    "wait_pending",
]
