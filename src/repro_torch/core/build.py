"""Staged BuildPlan pipeline: the one path every engine build lowers through.

A ``BuildPlan`` is an ordered list of named stages over a shared build-state
dict:

    shard_layout   host-side: shard geometry (``ShardLayout``)
    local_build    the structures, on the plan's device
    finalize       assemble the engine state (+ query closures)

Single-host engines carry the degenerate layout (one shard); the halo stage
of the mesh engines comes with the multi-device slice. ``plan_for(engine,
n, ...)`` resolves everything static at plan time (the device, the routing
threshold, the kernel geometry), so a plan is inspectable metadata: serving
derives its warmup batches from it (``warmup_bounds``). Port of the
single-host half of ``repro/core/build.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.obs import trace as obs_trace

from . import block_rmq, sparse_table

__all__ = [
    "BuildPlan",
    "BuildStage",
    "STAGE_NAMES",
    "ShardLayout",
    "build",
    "execute",
    "plan_for",
    "planner_names",
    "run_stages",
    "warmup_bounds",
]

STAGE_NAMES = ("shard_layout", "local_build", "finalize")


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
    meta: Dict[str, Any]  # resolved device / threshold / block_size / kernel config


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, {item})")


def _resolve_threshold(threshold, n: int) -> int:
    """The routing-threshold policy: ``None`` -> sqrt(n); an int pins it."""
    from . import hybrid

    if threshold is None:
        return max(1, int(round(n**hybrid.DEFAULT_THRESHOLD_FRAC)))
    if isinstance(threshold, (int, np.integer)) and not isinstance(threshold, bool):
        return int(threshold)
    if threshold in ("cached", "calibrated"):
        raise _not_ported(f"threshold={threshold!r} (the calibration cache)", "queue 1 step 4")
    raise ValueError(f"threshold must be an int or None; got {threshold!r}")


def _resolve_kernel_config(kernel_config, block_size: Optional[int] = None):
    """The kernel launch-geometry policy: ``None`` -> the default config; a
    ``KernelConfig`` (or compatible tuple) pins it."""
    from repro_torch.kernels import tuning

    if kernel_config is None:
        return tuning.default_config(block_size if block_size is not None else 128)
    if isinstance(kernel_config, str):
        raise _not_ported(f"kernel_config={kernel_config!r} (the autotuner)", "queue 1 step 8")
    return tuning.KernelConfig(*kernel_config)


# --- pipeline execution -----------------------------------------------------


def run_stages(plan: BuildPlan, state: dict, *, observer: Optional[Callable] = None):
    """Advance ``state`` through ``plan``'s stages; return ``state["result"]``.

    ``observer(stage_name, state)`` fires after each stage. When the
    process-global tracer is enabled, each stage lands as a span (named
    after the stage, ``engine`` attr from the plan) under the ambient span.
    """
    tr = obs_trace.get_tracer()
    if not tr.enabled:
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


_PLANNERS: Dict[str, Callable] = {}


def _planner(name: str):
    def deco(fn):
        _PLANNERS[name] = fn
        return fn

    return deco


def planner_names() -> Tuple[str, ...]:
    return tuple(sorted(_PLANNERS))


def plan_for(engine: str, n: int, *, device=None, **kwargs) -> BuildPlan:
    """Resolve the staged BuildPlan for ``engine`` over a length-``n`` array.

    ``device=None`` means CUDA, and raises when CUDA is absent.
    """
    try:
        planner = _PLANNERS[engine]
    except KeyError:
        raise ValueError(
            f"no build planner for engine {engine!r}; have {planner_names()}"
        ) from None
    return planner(int(n), device=resolve(device), **kwargs)


def build(engine: str, x, *, device=None, observer=None, **kwargs):
    """The single build entry point: ``plan_for`` + ``execute`` in one call."""
    plan = plan_for(engine, len(x), device=device, **kwargs)
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
def _plan_sparse_table(n, *, device):
    return _single_host_plan("sparse_table", n, sparse_table.build, device, with_x=True)


@_planner("block")
def _plan_block(n, *, device, block_size=128):
    return _single_host_plan(
        "block",
        n,
        lambda x: block_rmq.build(x, block_size, device=device),
        device,
        meta={"block_size": block_size},
    )


@_planner("fused")
def _plan_fused(n, *, device, block_size=None, kernel_config=None):
    cfg = _resolve_kernel_config(kernel_config, block_size)
    # An explicit block_size pins the config's, so the two never disagree.
    bs = block_size if block_size is not None else cfg.block_size

    def build_fn(x):
        from repro_torch.kernels import ops

        return ops.build(x, bs, device=device)

    def fin(state):
        state["result"] = (state["built"], cfg)
        return state

    meta = {"block_size": bs, "kernel_config": cfg}
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
):
    if use_kernels is None:
        # The reference asks for a TPU backend; the port for a CUDA structure.
        use_kernels = device.type == "cuda"
    thr = _resolve_threshold(threshold, n)
    # The kernel geometry, within this build's block size. Resolved only
    # when the short path runs the kernels.
    cfg = _resolve_kernel_config(kernel_config, block_size) if use_kernels else None
    layout = ShardLayout(n=n, n_pad=n, num_shards=1, shard_len=n)

    def local(state):
        x = state["x"]
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
            state["blocked"], state["st"], state["x"], thr, use_kernels, cfg
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
        },
    )
