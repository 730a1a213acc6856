"""Staged BuildPlan pipeline: the one path every engine build lowers through.

A ``BuildPlan`` is an ordered list of named stages over a shared build-state
dict:

    shard_layout   host-side: shard geometry (``ShardLayout``) + padding
    local_build    per-shard structures, no communication
    halo_exchange  the distributed doubling recurrence (mesh engines only)
    finalize       assemble the engine state (+ query closures)

and the online-update plans (``update_plan``) run two more over a delta
batch: ``apply_deltas`` then ``publish`` (``repro_torch.update``).
Single-host engines carry the degenerate layout (one shard) and skip the
halo stage; the mesh engines (``distributed``, ``sharded_st``,
``sharded_hybrid``) get real sharding over a ``launch.mesh.Mesh``, and the
column-sharded doubling table a build whose per-device memory is bounded
by the shard (``distributed.st_local_level0`` / ``st_halo_doubling``).
``plan_for(engine, n, ...)`` resolves everything static at plan time (the
device or mesh, the shard geometry, the routing threshold, the kernel
geometry, the distribution mode), so a plan is inspectable metadata:
serving derives its warmup batches from it (``warmup_bounds``). Port of
``repro/core/build.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.obs import trace as obs_trace

from . import block_rmq, calib_cache, distributed, lane_rmq, lca, packing, sparse_table

__all__ = [
    "BuildPlan",
    "BuildStage",
    "STAGE_NAMES",
    "ShardLayout",
    "build",
    "default_mesh",
    "execute",
    "execute_update",
    "plan_for",
    "planner_names",
    "run_stages",
    "update_plan",
    "warmup_bounds",
]

# Canonical stage order: the build pipeline, then the online-update pipeline
# (``apply_deltas`` patches the structures from a coalesced DeltaBatch,
# ``publish`` installs the patched state as the next MVCC version).
STAGE_NAMES = (
    "shard_layout",
    "local_build",
    "halo_exchange",
    "finalize",
    "apply_deltas",
    "publish",
)


class ShardLayout(NamedTuple):
    """Static shard geometry, resolved at plan time from ``n`` alone."""

    n: int  # logical array length (pre-padding)
    n_pad: int  # padded length (shard-divisible)
    num_shards: int  # flattened structure-shard count (1 on a single host)
    shard_len: int  # columns per structure shard (n_pad on a single host)


class BuildStage(NamedTuple):
    """One named pipeline stage: ``fn`` advances the build-state dict."""

    name: str  # one of STAGE_NAMES
    fn: Callable[[dict], dict]


class BuildPlan(NamedTuple):
    """A fully-resolved build: static layout + metadata + executable stages."""

    engine: str
    layout: ShardLayout
    stages: Tuple[BuildStage, ...]
    meta: Dict[str, Any]  # resolved device / mesh / threshold / block_size / kernel config


def default_mesh(device=None):
    """The all-devices 1-D mesh: ``(mesh, ("shard",))`` — the one definition
    of "no mesh was passed", shared by the registry and the serve CLI.

    ``device=None`` (or ``"cuda"``) spans every visible CUDA device, and
    raises when CUDA is absent; an indexed card or ``"cpu"`` gives a
    one-shard mesh on it.
    """
    from repro_torch.launch.mesh import make_mesh

    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh((torch.cuda.device_count(),), ("shard",)), ("shard",)
    return make_mesh((1,), ("shard",), devices=dev), ("shard",)


def _mesh_or_default(mesh, axis_names, device):
    if mesh is None:
        return default_mesh(device)
    return mesh, tuple(axis_names if axis_names is not None else mesh.axis_names)


def _resolve_threshold(
    threshold,
    n: int,
    block_size: int,
    *,
    backend: str,
    n_devices: Optional[int] = None,
    cache_path=None,
    calibrate_kw: Optional[dict] = None,
    key_mode: Optional[str] = None,
    key_mesh_shape=None,
    layout: Optional[str] = None,
) -> int:
    """The routing-threshold policy, shared by both hybrid planners.

    ``None`` -> deterministic sqrt(n) (never touches machine state);
    ``"cached"`` -> persistent cache with the sqrt(n) fallback, never
    measuring; ``"calibrated"`` -> measure via ``hybrid.calibrate`` on a
    miss and persist (``calibrate_kw`` carries the mesh for a sharded
    measurement); an int pins it. ``backend`` (the plan's device type) keys
    the cache. Sharded planners pass ``n_devices`` and
    ``key_mode``/``key_mesh_shape`` (cache key v2), so every (mode, mesh
    factoring) owns its threshold; ``layout`` (cache key v3) scopes the
    measurement to a packed word layout. ``cache_path`` overrides the
    cache file.
    """
    from . import hybrid  # deferred: hybrid lowers its build through here

    if threshold is None:
        return max(1, int(round(n**hybrid.DEFAULT_THRESHOLD_FRAC)))
    if isinstance(threshold, (int, np.integer)) and not isinstance(threshold, bool):
        return int(threshold)
    key_kw = dict(n_devices=n_devices, mode=key_mode, mesh_shape=key_mesh_shape, layout=layout)
    if threshold == "cached":
        key = calib_cache.cache_key(n, block_size, backend=backend, **key_kw)
        hit = calib_cache.load(key, path=cache_path)
        if hit is not None:
            return hit
        return max(1, int(round(n**hybrid.DEFAULT_THRESHOLD_FRAC)))
    if threshold == "calibrated":
        return calib_cache.get_threshold(
            n,
            block_size,
            backend=backend,
            path=cache_path,
            **key_kw,
            **(calibrate_kw or {}),
        )
    raise ValueError(
        f"threshold must be an int, None, 'cached' or 'calibrated'; got {threshold!r}"
    )


def _norm_packed(packed) -> Optional[str]:
    """Normalise the ``packed=`` build kwarg to a layout request or ``None``.

    ``None``/``False``/``"unpacked"`` -> unpacked structures; ``True`` ->
    ``"auto"``; otherwise one of ``packing.PACKED_LAYOUTS`` or ``"auto"``.
    The request resolves to a concrete ``PackSpec`` only at execute time
    (``packing.spec_for``): the winning layout depends on the data.
    """
    if packed is None or packed is False:
        return None
    if packed is True:
        return "auto"
    packed = str(packed)
    if packed == "unpacked":
        return None
    if packed != "auto" and packed not in packing.PACKED_LAYOUTS:
        raise ValueError(
            f"packed must be one of {('auto',) + packing.PACKED_LAYOUTS}, "
            f"a bool, or None; got {packed!r}"
        )
    return packed


def _resolve_kernel_config(kernel_config, n: int, block_size: Optional[int], device):
    """The kernel launch-geometry policy (mirrors ``_resolve_threshold``).

    ``None`` -> the deterministic default config (never touches machine
    state); ``"cached"`` -> the persistent cache, default fallback, never
    measuring; ``"tuned"`` -> the cache, sweeping via ``tuning.autotune`` on
    ``device`` only on a miss; a ``tuning.KernelConfig`` (or compatible
    tuple) pins it. ``block_size`` pins that knob when the caller's
    structure already committed to one.
    """
    from repro_torch.kernels import tuning

    if kernel_config is None or isinstance(kernel_config, str):
        return tuning.get_config(
            n, policy=kernel_config, block_size=block_size, backend=device.type, device=device
        )
    return tuning.KernelConfig(*kernel_config)


# --- pipeline execution -----------------------------------------------------


def run_stages(plan: BuildPlan, state: dict, *, observer: Optional[Callable] = None):
    """Advance ``state`` through ``plan``'s stages; return ``state["result"]``.

    ``observer(stage_name, state)`` fires after each stage. When the
    process-global tracer is enabled or a profiler records
    (``obs.trace.tracing()``), each stage lands as a span (named after the
    stage, ``engine`` attr from the plan) under the ambient span.
    """
    tr = obs_trace.get_tracer()
    if not obs_trace.tracing():
        for stage in plan.stages:
            state = stage.fn(state)
            if observer is not None:
                observer(stage.name, state)
        return state["result"]
    for stage in plan.stages:
        with tr.span(stage.name, attrs={"engine": plan.engine}):
            state = stage.fn(state)
        if observer is not None:
            observer(stage.name, state)
    return state["result"]


def execute(plan: BuildPlan, x, *, observer: Optional[Callable] = None):
    """Run ``plan``'s build stages over ``x`` (moved to the plan's device)."""
    x = torch.as_tensor(x, device=plan.meta["device"])
    if x.ndim != 1 or x.shape[0] != plan.layout.n:
        raise ValueError(f"plan for n={plan.layout.n} executed on array of shape {tuple(x.shape)}")
    return run_stages(plan, {"x": x}, observer=observer)


# --- online-update pipeline --------------------------------------------------


def update_plan(
    engine: str,
    layout: ShardLayout,
    apply_fn: Callable[[dict], dict],
    publish_fn: Callable[[dict], dict],
    meta: Optional[Dict[str, Any]] = None,
) -> BuildPlan:
    """The two-stage online-update plan: ``apply_deltas`` -> ``publish``.

    ``apply_fn`` consumes ``state["deltas"]`` (a coalesced
    ``repro_torch.update.DeltaBatch``) and writes ``state["patched"]`` (the
    next engine state, copy-on-write over the previous version's leaves);
    ``publish_fn`` installs it as the next MVCC version and writes
    ``state["result"]`` (an ``UpdateResult``). ``update.OnlineEngine``
    constructs these plans; they run through the same ``run_stages``
    sequencer (and observer seam) as builds.
    """
    return BuildPlan(
        engine,
        layout,
        (BuildStage("apply_deltas", apply_fn), BuildStage("publish", publish_fn)),
        dict(meta or {}),
    )


def execute_update(plan: BuildPlan, deltas, *, observer: Optional[Callable] = None):
    """Run an update plan over a coalesced ``DeltaBatch``."""
    return run_stages(plan, {"deltas": deltas}, observer=observer)


_PLANNERS: Dict[str, Callable] = {}
_MESH_PLANNERS = set()


def _planner(name: str, *, mesh: bool = False):
    def deco(fn):
        _PLANNERS[name] = fn
        if mesh:
            _MESH_PLANNERS.add(name)
        return fn

    return deco


def planner_names() -> Tuple[str, ...]:
    return tuple(sorted(_PLANNERS))


def plan_for(engine: str, n: int, *, device=None, mesh=None, axis_names=None, **kwargs) -> BuildPlan:
    """Resolve the staged BuildPlan for ``engine`` over a length-``n`` array.

    ``device=None`` means CUDA, and raises when CUDA is absent. The mesh
    engines build over ``mesh`` (``axis_names``: its axes unless given);
    without one, over ``default_mesh(device)``. A mesh passed to a
    single-device engine raises.
    """
    try:
        planner = _PLANNERS[engine]
    except KeyError:
        raise ValueError(
            f"no build planner for engine {engine!r}; have {planner_names()}"
        ) from None
    if engine in _MESH_PLANNERS:
        return planner(int(n), device=device, mesh=mesh, axis_names=axis_names, **kwargs)
    if mesh is not None or axis_names is not None:
        raise ValueError(f"engine {engine!r} builds on one device: pass device=, not a mesh")
    return planner(int(n), device=resolve(device), **kwargs)


def build(engine: str, x, *, device=None, mesh=None, axis_names=None, observer=None, **kwargs):
    """The single build entry point: ``plan_for`` + ``execute`` in one call."""
    plan = plan_for(engine, len(x), device=device, mesh=mesh, axis_names=axis_names, **kwargs)
    return execute(plan, x, observer=observer)


def warmup_bounds(plan: BuildPlan) -> Callable[[int], list]:
    """Plan-derived warmup batches: ``(size) -> [(l, r), ...]`` int32 arrays.

    One batch per query regime the built engine can dispatch to: threshold
    engines get a longest-still-short probe and (when any length routes
    long) a full-range probe; single-path engines get the two extremes.
    """
    n = plan.layout.n
    thr = plan.meta.get("threshold")

    def bounds(size: int) -> list:
        zeros = np.zeros(size, np.int32)
        if thr is None:  # single-path engine: the two extremes
            out = [(zeros, zeros)]
            if n > 1:
                out.append((zeros, np.full(size, n - 1, np.int32)))
            return out
        out = []
        if thr >= 1:  # longest range that still routes short
            out.append((zeros, np.full(size, min(thr, n) - 1, np.int32)))
        if n > thr:  # full range routes long
            out.append((zeros, np.full(size, n - 1, np.int32)))
        return out

    return bounds


# --- single-host planners ---------------------------------------------------


def _single_host_plan(engine, n, build_fn, device, *, with_x=False, meta=None) -> BuildPlan:
    layout = ShardLayout(n=n, n_pad=n, num_shards=1, shard_len=n)

    def local(state):
        state["built"] = build_fn(state["x"])
        return state

    def fin(state):
        state["result"] = (state["built"], state["x"]) if with_x else state["built"]
        return state

    return BuildPlan(
        engine,
        layout,
        (
            BuildStage("shard_layout", lambda state: state),
            BuildStage("local_build", local),
            BuildStage("finalize", fin),
        ),
        {"device": device, **(meta or {})},
    )


@_planner("sparse_table")
def _plan_sparse_table(n, *, device, packed=None):
    layout = _norm_packed(packed)
    if layout is None:
        return _single_host_plan("sparse_table", n, sparse_table.build, device, with_x=True)
    # Packed state is ``((PackedSparseTable, PackSpec), x)``: the registry
    # query dispatches on the tuple shape.
    return _single_host_plan(
        "sparse_table",
        n,
        lambda x: sparse_table.build_packed(x, layout=layout),
        device,
        with_x=True,
        meta={"packed": layout},
    )


@_planner("block")
def _plan_block(n, *, device, block_size=128, packed=None):
    layout = _norm_packed(packed)
    if layout is None:
        build_fn = lambda x: block_rmq.build(x, block_size, device=device)
    else:
        build_fn = lambda x: block_rmq.build_packed(x, block_size, layout=layout, device=device)
    return _single_host_plan(
        "block", n, build_fn, device, meta={"block_size": block_size, "packed": layout}
    )


@_planner("lane")
def _plan_lane(n, *, device):
    return _single_host_plan("lane", n, lambda x: lane_rmq.build(x, device=device), device)


@_planner("lca")
def _plan_lca(n, *, device):
    return _single_host_plan("lca", n, lambda x: lca.build(x, device=device), device, with_x=True)


@_planner("exhaustive")
def _plan_exhaustive(n, *, device):
    return _single_host_plan("exhaustive", n, lambda x: x, device, with_x=True)


@_planner("fused")
def _plan_fused(n, *, device, block_size=None, kernel_config=None, packed=None):
    layout = _norm_packed(packed)
    cfg = _resolve_kernel_config(kernel_config, n, block_size, device)
    # An explicit block_size pins the config's, so the two never disagree;
    # the config's own layout rides along unless ``packed=`` pins one.
    bs = block_size if block_size is not None else cfg.block_size
    if layout is None and cfg.layout != "unpacked":
        layout = cfg.layout
    if layout == "packed64":
        raise ValueError(
            "packed64 has no fused engine, as in the reference; use sparse_table/block/"
            "hybrid with packed= (the hybrid's short path runs its kernel), or "
            "packed32/quantized for the fused engines"
        )

    def build_fn(x):
        from repro_torch.kernels import ops

        if layout is None:
            return ops.build(x, bs, device=device)
        return ops.build_packed(x, bs, layout=layout, device=device)

    def fin(state):
        state["result"] = (state["built"], cfg)
        return state

    meta = {"block_size": bs, "kernel_config": cfg, "packed": layout}
    plan = _single_host_plan("fused", n, build_fn, device, meta=meta)
    stages = tuple(BuildStage("finalize", fin) if s.name == "finalize" else s for s in plan.stages)
    return plan._replace(stages=stages)


@_planner("hybrid")
def _plan_hybrid(
    n,
    *,
    device,
    block_size=128,
    threshold=None,
    use_kernels=None,
    kernel_config=None,
    packed=None,
):
    pack_layout = _norm_packed(packed)
    if use_kernels is None:
        # The reference asks for a TPU backend; the port for a CUDA structure.
        use_kernels = device.type == "cuda"
    thr = _resolve_threshold(
        threshold,
        n,
        block_size,
        backend=device.type,
        calibrate_kw={"use_kernels": use_kernels, "device": device},
        layout=pack_layout,
    )
    # The kernel geometry, within this build's block size. Resolved only
    # when the short path runs the kernels.
    cfg = _resolve_kernel_config(kernel_config, n, block_size, device) if use_kernels else None
    layout = ShardLayout(n=n, n_pad=n, num_shards=1, shard_len=n)

    def local(state):
        x = state["x"]
        if pack_layout is not None:
            # One spec for both tiers, so words of both compare in one order.
            spec = packing.spec_for(x, n, pack_layout)
            state["spec"] = spec
            if use_kernels:
                from repro_torch.kernels import ops

                state["blocked"], _ = ops.build_packed(x, block_size, spec=spec, device=device)
            else:
                state["blocked"], _ = block_rmq.build_packed(x, block_size, spec=spec, device=device)
            state["st"], _ = sparse_table.build_packed(x, spec=spec)
            return state
        if use_kernels:
            from repro_torch.kernels import ops

            state["blocked"] = ops.build(x, block_size, device=device)
        else:
            state["blocked"] = block_rmq.build(x, block_size, device=device)
        state["st"] = sparse_table.build(x)
        return state

    def fin(state):
        from . import hybrid

        state["result"] = hybrid.assemble(
            state["blocked"], state["st"], state["x"], thr, use_kernels, cfg, spec=state.get("spec")
        )
        return state

    return BuildPlan(
        "hybrid",
        layout,
        (
            BuildStage("shard_layout", lambda state: state),
            BuildStage("local_build", local),
            BuildStage("finalize", fin),
        ),
        {
            "device": device,
            "block_size": block_size,
            "threshold": thr,
            "use_kernels": bool(use_kernels),
            "kernel_config": cfg,
            "packed": pack_layout,
        },
    )


# --- mesh planners ----------------------------------------------------------


def _st_layout(n: int, num: int) -> ShardLayout:
    n_pad = -(-max(n, 1) // num) * num
    return ShardLayout(n=n, n_pad=n_pad, num_shards=num, shard_len=n_pad // num)


def _sharded_st_stages(mesh, axis_names, layout, *, key: str = "st"):
    """The distributed doubling-table build as (layout, local, halo) stage fns.

    Shared by the standalone ``sharded_st`` plan and the sharded-hybrid
    plans; writes ``{key}`` (a ``ShardedSparseTable``) into the build state.
    """

    def lay(state):
        x = state["x"]
        # Pad columns with maxval; queries never index past n-1 and every
        # window [c, c + 2^k) they touch lies inside [l, r], so pads never
        # win. Each shard's columns land on its device.
        state[f"{key}_xp"] = distributed.shard_rows(x, mesh, axis_names, layout.shard_len, block_rmq.maxval(x.dtype))
        return state

    def local(state):
        state[f"{key}_level0"] = distributed.st_local_level0(state.pop(f"{key}_xp"), mesh, axis_names)
        return state

    def halo(state):
        idx0, val0 = state.pop(f"{key}_level0")
        idx, val = distributed.st_halo_doubling(idx0, val0, mesh, axis_names)
        state[key] = distributed.ShardedSparseTable(idx=idx, val=val)
        return state

    return lay, local, halo


def _mesh_meta(mesh, axis_names, **meta) -> dict:
    return {"device": distributed.home_device(mesh), "mesh": mesh, "axis_names": axis_names, **meta}


@_planner("sharded_st", mesh=True)
def _plan_sharded_st(n, *, device=None, mesh=None, axis_names=None):
    mesh, axis_names = _mesh_or_default(mesh, axis_names, device)
    layout = _st_layout(n, distributed.num_shards(mesh, axis_names))
    lay, local, halo = _sharded_st_stages(mesh, axis_names, layout)

    def fin(state):
        state["result"] = state["st"]
        return state

    return BuildPlan(
        "sharded_st",
        layout,
        (
            BuildStage("shard_layout", lay),
            BuildStage("local_build", local),
            BuildStage("halo_exchange", halo),
            BuildStage("finalize", fin),
        ),
        _mesh_meta(mesh, axis_names),
    )


def _no_quantized(pack_layout) -> None:
    if pack_layout == "quantized":
        raise ValueError(
            "quantized packing is single-host only: its exact-fallback gather "
            "needs the raw blocks resident, which the sharded merge does not "
            "ship; use packed32/packed64/auto for mesh engines"
        )


@_planner("distributed", mesh=True)
def _plan_distributed(n, *, device=None, mesh=None, axis_names=None, block_size=1024, packed=None):
    pack_layout = _norm_packed(packed)
    _no_quantized(pack_layout)
    mesh, axis_names = _mesh_or_default(mesh, axis_names, device)
    num = distributed.num_shards(mesh, axis_names)
    chunk = num * block_size
    n_pad = -(-max(n, 1) // chunk) * chunk
    layout = ShardLayout(n=n, n_pad=n_pad, num_shards=num, shard_len=n_pad // num)

    def local(state):
        if pack_layout is not None:
            # auto resolves to packed32/packed64 only, never quantized.
            spec = packing.spec_for(state["x"], n, pack_layout)
            state["spec"] = spec
            state["blocked"] = distributed.build_sharded_packed(state["x"], mesh, axis_names, block_size, spec)
        else:
            state["blocked"] = distributed.build_sharded(state["x"], mesh, axis_names, block_size)
        return state

    def fin(state):
        if "spec" in state:
            qfn = distributed.make_packed_query_fn(mesh, axis_names, state["spec"])
        else:
            qfn = distributed.make_query_fn(mesh, axis_names)
        state["result"] = (state["blocked"], qfn)
        return state

    return BuildPlan(
        "distributed",
        layout,
        (
            BuildStage("shard_layout", lambda state: state),
            BuildStage("local_build", local),
            BuildStage("finalize", fin),
        ),
        _mesh_meta(mesh, axis_names, block_size=block_size, packed=pack_layout),
    )


def _mode_axes(mode: str, axis_names: Tuple[str, ...]):
    """(structure axes, batch axes) per distribution mode.

    ``shard_2d`` puts the structure on the first axis and the batch on the
    rest; on a 1-axis mesh it degrades to ``shard_structure``.
    """
    if mode == "shard_structure":
        return axis_names, ()
    if mode == "shard_batch":
        return (), axis_names
    return axis_names[:1], axis_names[1:]  # shard_2d


@_planner("sharded_hybrid", mesh=True)
def _plan_sharded_hybrid(
    n,
    *,
    device=None,
    mesh=None,
    axis_names=None,
    block_size=128,
    threshold=None,
    mode="shard_structure",
    cache_path=None,
    packed=None,
):
    from . import sharded_hybrid

    if mode not in sharded_hybrid.MODES:
        raise ValueError(f"unknown mode {mode!r}; have {sharded_hybrid.MODES}")
    pack_layout = _norm_packed(packed)
    _no_quantized(pack_layout)
    mesh, axis_names = _mesh_or_default(mesh, axis_names, device)
    num = distributed.num_shards(mesh, axis_names)
    struct_axes, batch_axes = _mode_axes(mode, axis_names)
    thr = _resolve_threshold(
        threshold,
        n,
        block_size,
        backend=distributed.home_device(mesh).type,
        n_devices=num,
        cache_path=cache_path,
        # Sharded-aware measurement: calibrate times the sharded constituents
        # on this very mesh, so the cached value reflects the merge costs.
        calibrate_kw={"use_kernels": False, "mesh": mesh, "axis_names": axis_names},
        # Cache key v2: the measurement varies per (mode, mesh factoring).
        key_mode=mode,
        key_mesh_shape=tuple(mesh.shape[a] for a in mesh.axis_names),
        layout=pack_layout,
    )
    num_struct = distributed.num_shards(mesh, struct_axes)
    layout = _st_layout(n, num_struct)

    stages = []
    if struct_axes:
        lay, st_local, st_halo = _sharded_st_stages(mesh, struct_axes, layout)

        if pack_layout is not None:

            def local(state):
                x = state["x"]
                # One spec for both tiers (same key bias / idx width), so the
                # packed halo recurrence and the blocked merge share a total
                # order. Words carry GLOBAL indices: merges need no per-shard
                # offsetting and the halo reads ONE plane per level.
                spec = packing.spec_for(x, n, pack_layout)
                state["spec"] = spec
                state["blocked"] = distributed.build_sharded_packed(x, mesh, struct_axes, block_size, spec)
                words = distributed.pack_global(x, spec, layout.n_pad)
                state["st_w0"] = distributed.shard_rows(words, mesh, struct_axes, layout.shard_len)
                return state

            def halo(state):
                words = distributed.st_halo_doubling_packed(state.pop("st_w0"), mesh, struct_axes, state["spec"])
                state["st"] = sparse_table.PackedSparseTable(words=words)
                return state

            stages.append(BuildStage("shard_layout", lambda state: state))
            stages.append(BuildStage("local_build", local))
            stages.append(BuildStage("halo_exchange", halo))
        else:

            def local(state):
                state["blocked"] = distributed.build_sharded(state["x"], mesh, struct_axes, block_size)
                return st_local(state)

            stages.append(BuildStage("shard_layout", lay))
            stages.append(BuildStage("local_build", local))
            stages.append(BuildStage("halo_exchange", st_halo))
    else:  # shard_batch: replicated structures, no halo stage

        def local(state):
            x = state["x"]
            if pack_layout is not None:
                spec = packing.spec_for(x, n, pack_layout)
                state["spec"] = spec
                state["blocked"] = distributed.build_replicated_packed(x, mesh, block_size, spec)
                state["st"] = distributed.build_replicated_st_packed(x, mesh, spec)
            else:
                state["blocked"] = distributed.build_replicated(x, mesh, block_size)
                state["st"] = distributed.build_replicated_st(x, mesh)
            return state

        stages.append(BuildStage("shard_layout", lambda state: state))
        stages.append(BuildStage("local_build", local))

    def fin(state):
        state["result"] = sharded_hybrid.assemble(
            state["blocked"],
            state["st"],
            n=n,
            threshold=thr,
            mode=mode,
            mesh=mesh,
            axis_names=axis_names,
            dtype=state["x"].dtype,
            spec=state.get("spec"),
        )
        return state

    stages.append(BuildStage("finalize", fin))
    return BuildPlan(
        "sharded_hybrid",
        layout,
        tuple(stages),
        _mesh_meta(
            mesh,
            axis_names,
            block_size=block_size,
            threshold=int(thr),
            mode=mode,
            struct_axes=struct_axes,
            batch_axes=batch_axes,
            packed=pack_layout,
        ),
    )
