"""Deterministic synthetic data pipeline.

Port of ``repro/data/pipeline.py``. Batches are a pure function of
(seed, step), drawn with numpy's ``SeedSequence([seed, step])`` exactly as
the reference draws them, so both packages see the same token stream and a
restarted job replays it.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve

__all__ = ["synthetic_batch", "batch_iterator", "synthetic_documents"]


def synthetic_batch(cfg, batch: int, seq_len: int, *, seed: int, step: int, device=None) -> dict:
    """{tokens|embeds, labels} for one step; stateless and replayable."""
    dev = resolve(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    labels = rng.integers(0, cfg.vocab_size, (batch, seq_len), dtype=np.int64)
    out = {"labels": torch.from_numpy(labels.astype(np.int32)).to(dev)}
    if cfg.embeds_input:
        emb = rng.standard_normal((batch, seq_len, cfg.d_model), dtype=np.float32)
        out["embeds"] = torch.from_numpy(emb).to(dev).to(cfg.dtype)
    else:
        tokens = rng.integers(0, cfg.vocab_size, (batch, seq_len), dtype=np.int64)
        out["tokens"] = torch.from_numpy(tokens.astype(np.int32)).to(dev)
    return out


def batch_iterator(cfg, batch: int, seq_len: int, *, seed: int, start_step: int = 0, device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, batch, seq_len, seed=seed, step=step, device=device)
        step += 1


def synthetic_documents(num_docs: int, max_len: int, *, seed: int) -> np.ndarray:
    """Document lengths with a heavy tail (log-normal), for the packer."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.normal(np.log(max_len) - 1.5, 0.8, num_docs))
    return np.clip(lens, 1, max_len).astype(np.int64)
