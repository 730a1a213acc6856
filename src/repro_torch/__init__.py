"""repro_torch — the blocked RMQ engines of ``repro`` on PyTorch and CUDA.

A port of the JAX package ``repro`` (which stays the reference) to an
NVIDIA H100. It mirrors ``repro``'s relative module paths, public names and
the ``(idx int32, val x.dtype)`` query contract. The Pallas kernels of the
served path are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use and bound through ``ctypes``; beside each kernel sits a
plain PyTorch version that runs for CPU tensors.

Public entry points take ``device=``; the default is CUDA, and they raise
when CUDA is absent rather than running on the CPU. This package imports
``torch``, numpy and the standard library only.
"""

__version__ = "0.1.0"
