"""Roofline terms for a dry-run cell, at an H100's peaks.

Port of ``repro/launch/roofline.py``. Terms per (arch × shape × mesh), in
seconds, from per-device counts:
    compute    = flops / 989e12             [dense bf16 tensor-core peak]
    memory     = bytes / 3.35e12            [HBM3]
    collective = collective_bytes / 50e9    [one GPU's inter-node link]

The counts come from ``launch.dryrun``: flops and bytes walked on torch's
``meta`` device and divided over the mesh, collective bytes from its
analytic model over the sharding specs. ``collective_bytes`` parses a
partitioned XLA HLO text as the reference's does (the sum of result-shape
bytes of every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute instruction, an async ``-done`` not counted again); the
port partitions no program, so the dry run passes ``hlo_text=""`` and sets
the collective term itself, as the reference's dry run does. MODEL_FLOPS is
global, so the usefulness ratio multiplies per-device flops back by the
chip count.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, asdict

__all__ = ["HW", "collective_bytes", "roofline_terms", "Roofline"]

# An H100 SXM (NVIDIA's data sheet). The key names are the reference's.
# ``ici_bw`` is the link a collective of the production meshes crosses: a
# DGX H100 node holds 8 GPUs, so each 16-wide axis of the 16 x 16 and
# 2 x 16 x 16 meshes spans two nodes, and its traffic leaves the node on
# the GPU's ConnectX-7 NDR InfiniBand port, 400 Gb/s = 50 GB/s. NVLink 4's
# 450 GB/s per direction per GPU joins only the 8 GPUs of one node, which
# no production axis stays inside.
HW = {
    "peak_flops": 989e12,  # dense bf16 / GPU
    "hbm_bw": 3.35e12,  # bytes/s / GPU, HBM3
    "ici_bw": 50e9,  # bytes/s / GPU, inter-node (InfiniBand NDR)
}

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "e4m3": 1, "e5m2": 1,
}

_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\S+))\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """Per-collective-kind result bytes in the (per-device) HLO."""
    out: dict[str, int] = {}
    seen_done = set()
    for m in _COLL_RE.finditer(hlo_text):
        shapes = m.group(1) or m.group(2)
        kind = m.group(3)
        full = m.group(0)
        # avoid double counting async start/done pairs: skip "-done"
        if "-done(" in full:
            continue
        out[kind] = out.get(kind, 0) + _shape_bytes(shapes)
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes_per_dev: float
    coll_breakdown: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    bytes_per_device: float | None = None

    def to_dict(self):
        return asdict(self)


def roofline_terms(
    *, arch: str, shape: str, mesh_name: str, chips: int,
    cost: dict, hlo_text: str, model_flops: float, bytes_per_device=None,
) -> Roofline:
    flops = float(cost.get("flops", 0.0))  # per device
    byt = float(cost.get("bytes accessed", 0.0))  # per device
    coll = collective_bytes(hlo_text)
    coll_total = float(sum(coll.values()))  # per device
    t_c = flops / HW["peak_flops"]
    t_m = byt / HW["hbm_bw"]
    t_x = coll_total / HW["ici_bw"]  # per-device bytes over per-link BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byt,
        coll_bytes_per_dev=coll_total, coll_breakdown=coll,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        bytes_per_device=bytes_per_device,
    )
