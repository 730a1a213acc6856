"""Engine registry: one uniform ``EngineSpec`` per engine of the served path.

Conformance contract, as in the reference: ``build(x, device=None) ->
state``; ``query(state, l, r) -> (idx, val)`` with exact leftmost-tie
argmin indices (int32) and the corresponding values, as tensors on the
state's device. Engines whose native query returns only indices are wrapped
with a value gather. Every build lowers through the ``core.build``
BuildPlan pipeline; ``plan_for_serving``/``build_for_serving`` resolve the
plan from the declared serving capabilities (``serve_plan``), validating
kwargs at one enforcement point. Engines with a ``packed`` build kwarg build
packed word structures on request; their state is then a ``(structure,
PackSpec)`` pair. The hybrid serve plans read the routing threshold and
the kernel geometry from the calibration cache (``"cached"``; the serve
CLI's ``--calibrate``/``--tune`` measure on a miss). The mesh engines
(``needs_mesh``: ``distributed``, ``sharded_hybrid``,
``packed_sharded_hybrid``) take ``mesh``/``axis_names`` beside the build
kwargs and build over ``default_mesh(device)`` without them. Port of
``repro/core/registry.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from . import block_rmq, build as build_mod, exhaustive, hybrid, lane_rmq, lca, packing, sharded_hybrid, sparse_table

__all__ = [
    "EngineSpec",
    "ENGINES",
    "build_for_serving",
    "default_mesh",
    "get",
    "names",
    "packed_spec",
    "plan_for_serving",
    "serveable_names",
    "updatable_names",
]


class EngineSpec(NamedTuple):
    """An engine plus its declared serving capabilities.

    ``build``/``query`` are the conformance contract every oracle sweep
    uses. ``build_kwargs`` is the vocabulary of serving build options the
    engine understands. ``serve_plan`` resolves the engine's serving
    BuildPlan: ``(n, device, **kw) -> BuildPlan``; a mesh engine
    (``needs_mesh``) takes ``mesh``/``axis_names`` in ``kw`` and declares
    its distribution ``modes``. ``updatable`` enrolls it in the online
    updates. ``doc`` is one line for CLI help and error messages.
    """

    build: Callable  # (x, device=None) -> state
    query: Callable  # (state, l, r) -> (idx int32, val)
    serveable: bool = True
    build_kwargs: frozenset = frozenset()
    serve_plan: Optional[Callable] = None  # (n, device, **kw) -> BuildPlan
    # The engine enrolls in the online-update subsystem (``repro_torch.update``):
    # its structures are patched incrementally (delta patch + MVCC version
    # publish) instead of rebuilt. ``update.make_online`` validates the flag
    # against its per-engine patch implementations.
    updatable: bool = False
    doc: str = ""
    needs_mesh: bool = False  # builds over a launch.mesh.Mesh
    modes: tuple = ()  # distribution modes of a mesh engine


def _simple_serve_plan(planner: str, **fixed):
    def serve_plan(n, device, **kw):
        return build_mod.plan_for(planner, n, device=device, **{**fixed, **kw})

    return serve_plan


def _is_packed_state(s) -> bool:
    """Packed planner results are ``(structure, PackSpec)`` pairs."""
    return isinstance(s, tuple) and len(s) == 2 and isinstance(s[1], packing.PackSpec)


def packed_spec(state):
    """The ``PackSpec`` a served build resolved to, None when unpacked (or
    not kept: the ``distributed`` state): the (sharded) hybrid's ``spec``,
    or the ``(structure, PackSpec)`` pair that is the state (``block``) or
    its first part (``sparse_table``'s ``(table, x)``, the fused engines'
    ``(structure, config)``)."""
    if isinstance(state, (hybrid.HybridRMQ, sharded_hybrid.ShardedHybridRMQ)):
        return state.spec
    for s in (state, state[0] if isinstance(state, tuple) else None):
        if _is_packed_state(s):
            return s[1]
    return None


def _with_values(planner: str, query_fn, packed_query_fn=None, **spec_kw) -> EngineSpec:
    """Adapt an index-only engine to the uniform (idx, val) contract.

    The planner's finalize stage already pairs the built state with ``x``
    (``with_x``); the query wrapper gathers values from it. When the planner
    has a packed variant (``packed=`` kwarg), its state is
    ``((structure, PackSpec), x)`` and ``packed_query_fn`` serves it:
    packed queries return (idx, val) natively, so no gather is needed.
    """

    def build(x, device=None):
        return build_mod.build(planner, x, device=device)

    def query(state, l, r):
        s, x = state
        if packed_query_fn is not None and _is_packed_state(s):
            return packed_query_fn(*s, l, r)
        idx = query_fn(s, l, r)
        return idx, x[idx]

    return EngineSpec(build, query, **spec_kw)


def _block_query(state, l, r):
    """Blocked-engine query, dispatching on the packed tuple shape."""
    if _is_packed_state(state):
        return block_rmq.query_packed(*state, l, r)
    return block_rmq.query(state, l, r)


def _kernels_engine(block_size: int, kernel_config=None, doc: str = "") -> EngineSpec:
    """The fused-kernel engine: state is ``(FusedRMQ, KernelConfig)``.

    ``kernel_config`` pins the launch geometry (``fused128_dma`` forces the
    dma fetch strategy so both strategies ride every oracle sweep); a pinned
    variant serves its pin.
    """

    def query(state, l, r):
        from repro_torch.kernels import ops

        s, cfg = state
        if _is_packed_state(s):
            return ops.query_packed(*s, l, r, config=cfg)
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
        build_kwargs=frozenset({"block_size", "kernel_config", "packed"}),
        serve_plan=serve_plan,
        doc=doc or "fused blocked-RMQ CUDA kernel (plain PyTorch on CPU)",
    )


def default_mesh(device=None):
    """The all-devices 1-D serving mesh: ``(mesh, axis_names)``.

    The one definition of "no mesh was passed", shared with the BuildPlan
    pipeline (``core.build.default_mesh``) so planner defaults, serving
    builds and the serve CLI never disagree.
    """
    return build_mod.default_mesh(device)


# --- mesh engines ----------------------------------------------------------


def _distributed_query(state, l, r):
    s, qfn = state
    return qfn(s, l, r)


def _mesh_engine(planner: str, query, serve_kw: dict, build_kwargs, doc: str, **build_fixed) -> EngineSpec:
    """A mesh engine: ``build(x, device=None, mesh=None, axis_names=None)``
    over ``default_mesh(device)`` unless a mesh is given. Updatable, as in
    the reference: ``update.make_online(name, x, mesh=...)`` patches its
    shards copy-on-write (``core.distributed.patch_sharded*``).
    """

    def build(x, device=None, mesh=None, axis_names=None):
        return build_mod.build(planner, x, device=device, mesh=mesh, axis_names=axis_names, **build_fixed)

    return EngineSpec(
        build,
        query,
        build_kwargs=frozenset(build_kwargs),
        serve_plan=_simple_serve_plan(planner, **serve_kw),
        doc=doc,
        needs_mesh=True,
        updatable=True,
        modes=sharded_hybrid.MODES if planner == "sharded_hybrid" else (),
    )


ENGINES: dict = {
    "sparse_table": _with_values(
        "sparse_table",
        sparse_table.query,
        packed_query_fn=sparse_table.query_packed,
        build_kwargs=frozenset({"packed"}),
        serve_plan=_simple_serve_plan("sparse_table"),
        updatable=True,
        doc="O(1) doubling-table lookups",
    ),
    "block128": EngineSpec(
        lambda x, device=None: build_mod.build("block", x, device=device, block_size=128),
        _block_query,
        build_kwargs=frozenset({"packed"}),
        serve_plan=_simple_serve_plan("block", block_size=128),
        updatable=True,
        doc="plain PyTorch blocked, bs=128",
    ),
    "block256": EngineSpec(
        lambda x, device=None: build_mod.build("block", x, device=device, block_size=256),
        _block_query,
        build_kwargs=frozenset({"packed"}),
        serve_plan=_simple_serve_plan("block", block_size=256),
        updatable=True,
        doc="plain PyTorch blocked, bs=256",
    ),
    "lane": EngineSpec(
        lambda x, device=None: build_mod.build("lane", x, device=device),
        lane_rmq.query,
        serve_plan=_simple_serve_plan("lane"),
        doc="lane-RMQ: O(1) gathers over 128-wide lane blocks",
    ),
    "lca": _with_values(
        "lca",
        lca.query,
        serve_plan=_simple_serve_plan("lca"),
        doc="LCA/Euler-tour O(1) engine (host-built Cartesian tree)",
    ),
    # Test oracle, not a server: O(n) scan per query chunk.
    "exhaustive": _with_values(
        "exhaustive",
        lambda x, l, r: exhaustive.rmq_exhaustive(x, l, r, query_chunk=64),
        serveable=False,
        doc="O(n)-per-query scan oracle",
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
        build_kwargs=frozenset({"block_size", "threshold", "kernel_config", "packed"}),
        serve_plan=_simple_serve_plan(
            "hybrid", block_size=128, threshold="cached", kernel_config="cached"
        ),
        updatable=True,
        doc="range-adaptive blocked/sparse-table crossover dispatcher",
    ),
    # The packed-word hybrid: both tiers carry (value, index) words; the
    # layout resolves per array ("auto": packed32 when the key span fits,
    # else packed64).
    "packed_hybrid": EngineSpec(
        lambda x, device=None: build_mod.build(
            "hybrid", x, device=device, block_size=128, packed="auto"
        ),
        hybrid.query,
        build_kwargs=frozenset({"block_size", "threshold", "kernel_config", "packed"}),
        serve_plan=_simple_serve_plan(
            "hybrid", block_size=128, threshold="cached", kernel_config="cached", packed="auto"
        ),
        updatable=True,
        doc="hybrid over packed (value, index) word planes",
    ),
    # Mesh-sharded blocked engine (structure sharded, queries replicated).
    "distributed": _mesh_engine(
        "distributed",
        _distributed_query,
        {"block_size": 1024},
        {"block_size", "packed"},
        "mesh-sharded blocked engine, two-min merge",
        block_size=128,
    ),
    # Mesh-sharded range-adaptive dispatcher (over every visible card by
    # default; a one-shard mesh degenerates to the single-device hybrid).
    "sharded_hybrid": _mesh_engine(
        "sharded_hybrid",
        sharded_hybrid.query,
        {"block_size": 128, "threshold": "cached"},
        {"block_size", "threshold", "mode", "packed"},
        "sharded range-adaptive hybrid (shard_structure | shard_batch | shard_2d)",
        block_size=128,
    ),
    # Packed sharded hybrid: words carry global indices, so the sharded
    # merge is ONE min and the halo recurrence reads ONE plane per level.
    "packed_sharded_hybrid": _mesh_engine(
        "sharded_hybrid",
        sharded_hybrid.query,
        {"block_size": 128, "threshold": "cached", "packed": "auto"},
        {"block_size", "threshold", "mode", "packed"},
        "sharded hybrid over packed word planes (one-min merge, single-plane halos)",
        block_size=128,
        packed="auto",
    ),
}


def names() -> Tuple[str, ...]:
    return tuple(ENGINES)


def serveable_names() -> Tuple[str, ...]:
    return tuple(n for n, s in ENGINES.items() if s.serveable)


def updatable_names() -> Tuple[str, ...]:
    """Engines enrolled in the online-update subsystem (``repro_torch.update``)."""
    return tuple(n for n, s in ENGINES.items() if s.updatable)


def get(name: str) -> EngineSpec:
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown engine {name!r}; have {sorted(ENGINES)}") from None


def plan_for_serving(name: str, n: int, device=None, **kwargs):
    """Resolve engine ``name``'s serving BuildPlan on ``device``, validating kwargs.

    Unknown kwargs and unsupported modes raise ``ValueError`` naming the
    engine's declared capabilities — the single enforcement point behind
    CLI flag validation. A mesh engine also takes ``mesh``/``axis_names``
    (default: ``default_mesh(device)``).
    """
    spec = get(name)
    if not spec.serveable:
        raise ValueError(f"engine {name!r} is not serveable ({spec.doc})")
    mesh_kw = {k: kwargs.pop(k) for k in ("mesh", "axis_names") if k in kwargs and spec.needs_mesh}
    unknown = set(kwargs) - set(spec.build_kwargs)
    if unknown:
        raise ValueError(
            f"engine {name!r} does not accept {sorted(unknown)}; "
            f"declared build kwargs: {sorted(spec.build_kwargs)}"
        )
    if "mode" in kwargs and kwargs["mode"] not in spec.modes:
        raise ValueError(f"engine {name!r} does not support mode {kwargs['mode']!r}; have {spec.modes}")
    if spec.serve_plan is None:
        raise ValueError(f"engine {name!r} declares no serving BuildPlan")
    return spec.serve_plan(int(n), device, **mesh_kw, **kwargs)


def build_for_serving(name: str, x, device=None, **kwargs):
    """Build engine ``name`` for serving: resolve its plan, then execute it."""
    plan = plan_for_serving(name, len(x), device, **kwargs)
    return build_mod.execute(plan, x)
