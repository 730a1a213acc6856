"""repro_torch.core — the batched RMQ engines of the served path.

  * ``sparse_table`` — doubling table (the long-range path, and the level-2
    structure over block minima).
  * ``block_rmq``    — the paper's blocked structure in plain PyTorch; the
    oracle of the CUDA kernels in ``repro_torch.kernels``.
  * ``packing``      — order-isomorphic (value, index) words (packed64,
    packed32, quantized) for the packed halves of the structures.
  * ``lane_rmq``     — the O(1) gather engine over 128-wide lane blocks.
  * ``lca``          — the paper's GPU baseline: RMQ as LCA over the
    Cartesian tree's Euler tour (tree built on the host).
  * ``exhaustive``   — the brute-force baseline and second oracle.
  * ``hybrid``       — range-adaptive dispatch: short ranges to the blocked
    path (the fused CUDA kernel on the card), long ranges to the table;
    ``hybrid.calibrate`` measures the crossover.
  * ``distributed``  — the mesh-sharded blocked engine and the
    column-sharded doubling table with its halo-exchange build.
  * ``sharded_hybrid`` — ``hybrid``'s dispatch over the sharded
    constituents, in three distribution modes.
  * ``calib_cache``  — the persistent cache of measured thresholds and tuned
    kernel configs.
  * ``build``        — the staged BuildPlan pipeline every build lowers
    through, and the online-update plans (``update_plan``,
    ``execute_update``) of ``repro_torch.update``.
  * ``registry``     — one ``(build, query) -> (idx, val)`` spec per engine;
    ``updatable_names()`` lists the engines ``repro_torch.update`` patches.
"""

from . import (
    block_rmq,
    build,
    calib_cache,
    distributed,
    exhaustive,
    hybrid,
    lane_rmq,
    lca,
    packing,
    ref,
    registry,
    sharded_hybrid,
    sparse_table,
)

__all__ = [
    "block_rmq",
    "build",
    "calib_cache",
    "distributed",
    "exhaustive",
    "hybrid",
    "lane_rmq",
    "lca",
    "packing",
    "ref",
    "registry",
    "sharded_hybrid",
    "sparse_table",
]
