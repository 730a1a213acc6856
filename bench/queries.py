"""The query generator, frozen here: the paper's §6.4 range regimes, drawn on
the device from the seed.

A copy of ``repro_torch.serve.workload.make_queries`` (large: range length
uniform in [1, n]; medium and small: LogNormal(ln n^0.6 or ln n^0.3, 0.3),
clipped to [1, n] and truncated; the left end uniform over the places the
range fits), rewritten to draw with a ``torch.Generator`` on the device, so
that a pool of batches of 2^22 costs milliseconds and no host copy, and to
take its parameters from a traffic file's ``length`` entry:

    {"dist": "lognormal", "median_exponent": 0.3, "sigma": 0.3}
    {"dist": "uniform", "low": 1, "high": "n"}

Bounds are int32, as every engine takes them.
"""

from __future__ import annotations

import math

import torch

from bench.spec import seed_for

__all__ = ["INT32_MAX", "batch", "lengths", "pool"]

INT32_MAX = 2**31 - 1


def _size(v, n: int) -> int:
    return n if v == "n" else int(v)


def lengths(spec: dict, n: int, size: int, gen: torch.Generator, device) -> torch.Tensor:
    """``size`` range lengths in [1, n] (int64) of the distribution ``spec``."""
    dist = spec["dist"]
    if dist == "uniform":
        lo, hi = _size(spec.get("low", 1), n), _size(spec.get("high", "n"), n)
        if not 1 <= lo <= hi <= n:
            raise ValueError(f"uniform lengths [{lo}, {hi}] outside [1, {n}]")
        return torch.randint(lo, hi + 1, (size,), generator=gen, device=device, dtype=torch.int64)
    if dist == "lognormal":
        mu = math.log(n ** float(spec["median_exponent"]))
        z = torch.randn(size, generator=gen, device=device, dtype=torch.float64)
        length = torch.exp(mu + float(spec["sigma"]) * z)
        return torch.clamp(length, 1, n).to(torch.int64)  # truncates, as numpy's astype
    raise ValueError(f"unknown length distribution {dist!r} (want 'uniform' or 'lognormal')")


def batch(spec: dict, n: int, size: int, gen: torch.Generator, device):
    """One batch of ``size`` queries over ``[0, n)``: int32 ``(l, r)``."""
    if not 1 <= n <= INT32_MAX:
        raise ValueError(f"n={n} outside the engines' int32 index range")
    length = lengths(spec, n, size, gen, device)
    span = n - length + 1  # places the range fits, >= 1
    u = torch.rand(size, generator=gen, device=device, dtype=torch.float64)
    l = torch.minimum((u * span).to(torch.int64), span - 1)
    r = l + length - 1
    return l.to(torch.int32), r.to(torch.int32)


def pool(traffic: dict, n: int, size: int, seed: int, device) -> list:
    """The traffic's pool of ``traffic["pool"]`` distinct batches of
    ``size`` queries, from ``seed``: a list of ``(l, r)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_for(seed, "queries"))
    return [
        batch(traffic["length"], n, size, gen, device)
        for _ in range(int(traffic["pool"]))
    ]
