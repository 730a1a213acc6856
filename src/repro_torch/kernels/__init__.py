"""CUDA kernels of the RMQ engines (+ ops wrappers, plain oracles).

Each kernel module holds the wrapper (kernel for CUDA tensors, plain
PyTorch version for CPU tensors) and a launch counter; ``_build`` compiles
``csrc/`` with ``nvcc`` at first launch.
"""

from . import ops, ref, tuning
from .block_min import block_min
from .fused_query import fused_query, fused_query_packed
from .lane_query import lane_partials
from .rmq_query import rmq_partials
from .sparse_query import sparse_query

__all__ = [
    "ops",
    "ref",
    "tuning",
    "block_min",
    "fused_query",
    "fused_query_packed",
    "lane_partials",
    "rmq_partials",
    "sparse_query",
]
