"""Engine registry: one uniform ``EngineSpec`` per engine of the served path.

Conformance contract, as in the reference: ``build(x, device=None) ->
state``; ``query(state, l, r) -> (idx, val)`` with exact leftmost-tie
argmin indices (int32) and the corresponding values, as tensors on the
state's device. Engines whose native query returns only indices are wrapped
with a value gather. Every build lowers through the ``core.build``
BuildPlan pipeline; ``plan_for_serving``/``build_for_serving`` resolve the
plan from the declared serving capabilities (``serve_plan``), validating
kwargs at one enforcement point. Port of ``repro/core/registry.py`` for the
single-device engines of the served path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from . import block_rmq, build as build_mod, hybrid, sparse_table

__all__ = [
    "EngineSpec",
    "ENGINES",
    "build_for_serving",
    "get",
    "names",
    "plan_for_serving",
    "serveable_names",
]


class EngineSpec(NamedTuple):
    """An engine plus its declared serving capabilities.

    ``build``/``query`` are the conformance contract every oracle sweep
    uses. ``build_kwargs`` is the vocabulary of serving build options the
    engine understands. ``serve_plan`` resolves the engine's serving
    BuildPlan: ``(n, device, **kw) -> BuildPlan``. ``doc`` is one line for
    CLI help and error messages.
    """

    build: Callable  # (x, device=None) -> state
    query: Callable  # (state, l, r) -> (idx int32, val)
    serveable: bool = True
    build_kwargs: frozenset = frozenset()
    serve_plan: Optional[Callable] = None  # (n, device, **kw) -> BuildPlan
    doc: str = ""


def _simple_serve_plan(planner: str, **fixed):
    def serve_plan(n, device, **kw):
        return build_mod.plan_for(planner, n, device=device, **{**fixed, **kw})

    return serve_plan


def _sparse_table_query(state, l, r):
    table, x = state
    idx = sparse_table.query(table, l, r)
    return idx, x[idx]


def _kernels_engine(block_size: int, kernel_config=None, doc: str = "") -> EngineSpec:
    """The fused-kernel engine: state is ``(FusedRMQ, KernelConfig)``.

    ``kernel_config`` pins the launch geometry (``fused128_dma`` forces the
    dma fetch strategy so both strategies ride every oracle sweep); a pinned
    variant serves its pin.
    """

    def query(state, l, r):
        from repro_torch.kernels import ops

        s, cfg = state
        return ops.query(s, l, r, config=cfg)

    def serve_plan(n, device, **kw):
        if kernel_config is not None:
            kw["kernel_config"] = kernel_config
        kw.setdefault("block_size", block_size)
        return build_mod.plan_for("fused", n, device=device, **kw)

    return EngineSpec(
        lambda x, device=None: build_mod.build(
            "fused", x, device=device, block_size=block_size, kernel_config=kernel_config
        ),
        query,
        build_kwargs=frozenset({"block_size", "kernel_config"}),
        serve_plan=serve_plan,
        doc=doc or "fused blocked-RMQ CUDA kernel (plain PyTorch on CPU)",
    )


ENGINES: dict = {
    "sparse_table": EngineSpec(
        lambda x, device=None: build_mod.build("sparse_table", x, device=device),
        _sparse_table_query,
        serve_plan=_simple_serve_plan("sparse_table"),
        doc="O(1) doubling-table lookups",
    ),
    "block128": EngineSpec(
        lambda x, device=None: build_mod.build("block", x, device=device, block_size=128),
        block_rmq.query,
        serve_plan=_simple_serve_plan("block", block_size=128),
        doc="plain PyTorch blocked, bs=128",
    ),
    "block256": EngineSpec(
        lambda x, device=None: build_mod.build("block", x, device=device, block_size=256),
        block_rmq.query,
        serve_plan=_simple_serve_plan("block", block_size=256),
        doc="plain PyTorch blocked, bs=256",
    ),
    "fused128": _kernels_engine(128),
    "fused128_dma": _kernels_engine(
        128,
        kernel_config=(8, "dma", 128),  # (tile, fetch, block_size) pinned
        doc="fused kernel, one-hop value-augmented interior tables (any nb)",
    ),
    # Range-adaptive dispatcher over blocked + sparse-table paths.
    "hybrid": EngineSpec(
        lambda x, device=None: build_mod.build("hybrid", x, device=device, block_size=128),
        hybrid.query,
        build_kwargs=frozenset({"block_size", "threshold", "kernel_config"}),
        serve_plan=_simple_serve_plan("hybrid", block_size=128),
        doc="range-adaptive blocked/sparse-table crossover dispatcher",
    ),
}


def names() -> Tuple[str, ...]:
    return tuple(ENGINES)


def serveable_names() -> Tuple[str, ...]:
    return tuple(n for n, s in ENGINES.items() if s.serveable)


def get(name: str) -> EngineSpec:
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; have {sorted(ENGINES)}") from None


def plan_for_serving(name: str, n: int, device=None, **kwargs):
    """Resolve engine ``name``'s serving BuildPlan on ``device``, validating kwargs.

    Unknown kwargs raise ``ValueError`` naming the engine's declared
    capabilities — the single enforcement point behind CLI flag validation.
    """
    spec = get(name)
    if not spec.serveable:
        raise ValueError(f"engine {name!r} is not serveable ({spec.doc})")
    unknown = set(kwargs) - set(spec.build_kwargs)
    if unknown:
        raise ValueError(
            f"engine {name!r} does not accept {sorted(unknown)}; "
            f"declared build kwargs: {sorted(spec.build_kwargs)}"
        )
    if spec.serve_plan is None:
        raise ValueError(f"engine {name!r} declares no serving BuildPlan")
    return spec.serve_plan(int(n), device, **kwargs)


def build_for_serving(name: str, x, device=None, **kwargs):
    """Build engine ``name`` for serving: resolve its plan, then execute it."""
    plan = plan_for_serving(name, len(x), device, **kwargs)
    return build_mod.execute(plan, x)
