"""repro_torch.core — the batched RMQ engines of the served path.

  * ``sparse_table`` — doubling table (the long-range path, and the level-2
    structure over block minima).
  * ``block_rmq``    — the paper's blocked structure in plain PyTorch; the
    oracle of the CUDA kernels in ``repro_torch.kernels``.
  * ``hybrid``       — range-adaptive dispatch: short ranges to the blocked
    path (the fused CUDA kernel on the card), long ranges to the table.
  * ``build``        — the staged BuildPlan pipeline every build lowers
    through.
  * ``registry``     — one ``(build, query) -> (idx, val)`` spec per engine.
"""

from . import block_rmq, build, hybrid, ref, registry, sparse_table

__all__ = ["block_rmq", "build", "hybrid", "ref", "registry", "sparse_table"]
