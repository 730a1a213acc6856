"""Device resolution and tensor conversion shared by every entry point."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["as_index", "resolve", "to_numpy"]


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and CUDA is not available — the port never falls back to the
    CPU on its own; callers that want the CPU pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (want 'cuda' or 'cpu')")
    return dev


def as_index(a, device: torch.device) -> torch.Tensor:
    """Query bounds as an int32 tensor on ``device`` (numpy, list or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"query bounds must be integers, got {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def to_numpy(t) -> np.ndarray:
    """A host numpy copy of a tensor (one device-to-host copy for CUDA)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
