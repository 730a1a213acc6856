"""CUDA kernels of the served RMQ path (+ ops wrappers, plain oracles).

Each kernel module holds the wrapper (kernel for CUDA tensors, plain
PyTorch version for CPU tensors) and a launch counter; ``_build`` compiles
``csrc/`` with ``nvcc`` at first launch.
"""

from . import ops, ref, tuning
from .block_min import block_min
from .fused_query import fused_query

__all__ = ["ops", "ref", "tuning", "block_min", "fused_query"]
