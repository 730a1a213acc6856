"""The paper's array: ``n`` float32 values uniform in [0, 1), drawn on the
device from the seed in one call."""

import torch

from bench.spec import seed_for


def make(config: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "data"))
    return torch.rand(int(config["n"]), generator=gen, device=device, dtype=torch.float32)
