"""Sharding rules: parameter/batch/cache partition specs for any mesh.

Port of ``repro/launch/sharding.py``, over the port's ``launch.mesh.Mesh``
(or any object with ``axis_names`` and a ``shape`` dict). A spec is a
``PartitionSpec``: a tuple of axis names, ``None`` or tuples of names, one
per dimension, equal to ``tuple()`` of the reference's ``PartitionSpec``.

Strategy (DESIGN.md §4):
  * params: 2-D sharded — tensor-parallel dim over "model", the other big
    dim FSDP over "data". Pods are data-parallel replicas of params, so
    specs never mention "pod" for weights; batch shards over ("pod","data").
  * MoE experts: expert dim over "model" when divisible (arctic 128/16),
    otherwise F over "model" (grok 8 experts) — EP degenerates to TP.
  * decode caches: batch over DP when divisible, sequence over "model"
    (sequence-parallel cache for long-context), SSM state heads over "model".
  * every rule checks divisibility and falls back to replication, so any
    (arch × shape × mesh) cell has a spec.

Where a spec puts a leaf depends on the mesh. On a mesh whose positions
share one device (every position of a mesh on one card, or on the CPU)
the step builders compute there (``train.steps``) and ``named`` places each
leaf whole on that device; the specs only say where it would live. On a
mesh of ranks (``launch.mesh``: one process per device) ``named`` gives
each leaf a ``Sharding``: the ``DeviceMesh`` and one placement per mesh
axis, ``Shard(d)`` where the spec names that axis for dimension ``d``,
else ``Replicate()``; each leaf is then a DTensor holding only its rank's
shard. A dimension that names several axes, such as ``("data", "model")``,
splits over them major to minor, as the reference's ``PartitionSpec``
does.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import _dtensor
from repro_torch._tree import tree_map
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import Cache

__all__ = [
    "PartitionSpec",
    "P",
    "dp_axes",
    "batch_axes",
    "param_specs",
    "batch_specs",
    "cache_spec",
    "named",
    "place",
    "placements",
    "Sharding",
    "opt_state_specs",
    "mesh_device",
    "on_ranks",
    "step_device",
]


def _entry(axis):
    """A dimension's entry as the reference's ``PartitionSpec`` keeps it: a
    one-name tuple is the name, an empty tuple is None."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        return None if not axis else axis[0] if len(axis) == 1 else axis
    return axis


class PartitionSpec(tuple):
    """One entry per dimension: an axis name, a tuple of names, or None
    (replicated). A tree leaf, where a plain tuple would be a container."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_entry(a) for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def dp_axes(mesh) -> tuple:
    """Data-parallel axes: ("pod","data") on multi-pod, else ("data",)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_axes(cfg, mesh, batch: int) -> tuple | None:
    """Axes the batch dim shards over. Pure-FSDP configs spread the batch
    over every mesh axis; fall back through shorter prefixes when the batch
    doesn't divide (e.g. 256 sequences on the 512-chip multi-pod mesh)."""
    if cfg.parallelism == "fsdp":
        candidates = [tuple(mesh.axis_names), dp_axes(mesh)]
    else:
        candidates = [dp_axes(mesh)]
    for cand in candidates:
        if cand and _div(batch, mesh, cand):
            return cand
    return None


def _div(n: int, mesh, axis) -> bool:
    if axis is None:
        return True
    size = 1
    for a in axis if isinstance(axis, tuple) else (axis,):
        size *= mesh.shape[a]
    return n % size == 0


def _guard(shape: tuple, spec: tuple, mesh) -> PartitionSpec:
    """Replace any non-divisible dim sharding with replication."""
    return P(*(s if _div(dim, mesh, s) else None for dim, s in zip(shape, spec)))


# (tp_dim_last?, rule) per leaf name; 2-D core weights are (in, out).
_ROW = ("data", "model")  # shard out-features over model (wq, w_gate, in_proj)
_COL = ("model", "data")  # shard in-features over model (wo, w_down, out_proj)

_CORE_RULES: dict[str, tuple] = {
    "embed": _COL,  # (V, D): vocab over model, D fsdp
    "lm_head": _COL,
    "final_norm": (None,),
    "ln1": (None,),
    "ln2": (None,),
    "norm_w": (None,),
    "wq": _ROW,
    "wk": _ROW,
    "wv": _ROW,
    "wo": _COL,
    "bq": ("model",),
    "bk": ("model",),
    "bv": ("model",),
    "w_gate": _ROW,
    "w_up": _ROW,
    "w_down": _COL,
    "wr_gate": _ROW,
    "wr_up": _ROW,
    "wr_down": _COL,
    "router": ("data", None),
    "in_proj": _ROW,
    "out_proj": _COL,
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "a_log": (None,),
    "d_skip": (None,),
    "dt_bias": (None,),
}

_MOE_LEAVES = {"w_gate", "w_up", "w_down"}


def _leaf_spec(name: str, shape: tuple, cfg, mesh) -> PartitionSpec:
    core = _CORE_RULES[name]
    if cfg.num_experts and name in _MOE_LEAVES and len(shape) - len(core) >= 2:
        # expert-stacked (..., E, in, out): prefer EP over model axis
        if _div(cfg.num_experts, mesh, "model"):
            core = ("model", "data", None) if name != "w_down" else ("model", None, "data")
        else:
            core = (None,) + core
    lead = len(shape) - len(core)
    # FSDP spans ALL data-parallel axes: on the multi-pod mesh the "data"
    # placeholder becomes ("pod","data"). Pure-FSDP configs fold the model
    # axis into FSDP and drop TP entirely.
    if cfg.parallelism == "fsdp":
        fsdp = tuple(mesh.axis_names)
        spec = tuple(
            fsdp if s == "data" else (None if s == "model" else s)
            for s in (None,) * lead + tuple(core)
        )
    else:
        dp = dp_axes(mesh)
        spec = tuple(dp if s == "data" else s for s in (None,) * lead + tuple(core))
    return _guard(shape, spec, mesh)


def param_specs(cfg, mesh) -> Any:
    def walk(tree):
        return {
            k: walk(v) if isinstance(v, dict) else _leaf_spec(k, v, cfg, mesh)
            for k, v in tree.items()
        }

    return walk(model_lib.param_shapes(cfg))


def batch_specs(cfg, mesh, batch: int, seq_len: int, kind: str) -> Any:
    bspec = batch_axes(cfg, mesh, batch)
    if kind == "train":
        out = {"labels": P(bspec, None)}
        if cfg.embeds_input:
            out["embeds"] = P(bspec, None, None)
        else:
            out["tokens"] = P(bspec, None)
        return out
    if kind == "prefill":
        return P(bspec, None, None) if cfg.embeds_input else P(bspec, None)
    if kind == "decode":
        return P(bspec, None)  # (B, 1) token ids
    raise ValueError(kind)


def cache_spec(cfg, mesh, batch: int, capacity: int) -> Cache:
    """Specs for the decode cache (see module docstring)."""
    b = batch_axes(cfg, mesh, batch)
    # sequence-parallel cache whenever the model axis isn't already carrying
    # the batch (long-context: batch=1 decodes shard the 500k cache seq dim)
    seq = None
    if (b is None or "model" not in b) and _div(capacity, mesh, "model"):
        seq = "model"
    shapes = model_lib.cache_shapes(cfg, batch, capacity)
    kw = {}
    if "k" in shapes:
        kw["k"] = P(None, b, seq, None, None)
        kw["v"] = P(None, b, seq, None, None)
    if "conv" in shapes:
        conv_c = shapes["conv"][-1]
        kw["conv"] = P(None, b, None, "model" if _div(conv_c, mesh, "model") else None)
        h = shapes["ssd"][2]
        kw["ssd"] = P(None, b, "model" if _div(h, mesh, "model") else None, None, None)
    return Cache(length=P(), **kw)


def opt_state_specs(pspecs) -> Any:
    """AdamW state inherits param specs (ZeRO: moments sharded like params)."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=P(), master=pspecs, mu=pspecs, nu=pspecs)


def on_ranks(mesh) -> bool:
    """Whether ``mesh`` is a mesh of ranks (``launch.mesh``)."""
    return getattr(mesh, "device_mesh", None) is not None


def mesh_device(mesh) -> torch.device:
    """The device a step built for ``mesh`` computes on: the one physical
    device its positions share, or, on a mesh of ranks, this rank's own. A
    mesh of one process over several devices raises
    ``NotImplementedError`` (start one rank per device instead); a
    ``meta`` mesh, a shape to plan against, raises ``ValueError``."""
    if on_ranks(mesh):
        return mesh.rank_device
    devs = mesh.physical_devices
    if len(devs) != 1:
        raise NotImplementedError(
            f"an LM step computes on one device per process; this mesh spans {[str(d) for d in devs]}: "
            "start a rank per device (launch.ranks) and build the mesh there with make_mesh(shape, axes)"
        )
    if devs[0].type == "meta":
        raise ValueError("a mesh on the meta device plans shapes; it holds no memory to compute on")
    return devs[0]


def step_device(mesh) -> torch.device:
    """The device a step built for ``mesh`` computes on: ``mesh_device``'s,
    or ``meta`` for a mesh whose every position is on ``meta``. There a step
    walks its shapes and allocates nothing (the dry run,
    ``launch/dryrun.py``); ``named`` still refuses such a mesh."""
    devs = mesh.physical_devices
    if not on_ranks(mesh) and len(devs) == 1 and devs[0].type == "meta":
        return devs[0]
    return mesh_device(mesh)


def placements(mesh, spec) -> tuple:
    """One DTensor placement per mesh axis for ``spec``: ``Shard(d)`` on
    each axis of more than one rank that the spec names for dimension
    ``d``, else ``Replicate()`` (a shard over one rank is the whole
    dimension, and DTensor cannot merge every dimension sharded so). Several
    names on one dimension must come in mesh order (DTensor splits major to
    minor in that order)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.axis_names)
    seen = set()
    for d, entry in enumerate(spec):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        if list(names) != sorted(names, key=mesh.axis_names.index):
            raise ValueError(f"{spec}: the axes of dimension {d} must come in the mesh's order {mesh.axis_names}")
        for name in names:
            if name in seen:
                raise ValueError(f"{spec} names axis {name!r} twice")
            seen.add(name)
            if mesh.shape[name] > 1:
                out[mesh.axis_names.index(name)] = Shard(d)
    return tuple(out)


class Sharding:
    """Where a leaf lives on a mesh of ranks (the reference's
    ``NamedSharding``): ``device_mesh`` and ``placements``, one per mesh
    axis. ``place(t)`` turns a whole tensor or numpy array into the DTensor
    (each rank slices out its shard) and re-lays a DTensor out."""

    __slots__ = ("device_mesh", "placements")

    def __init__(self, device_mesh, placements):
        self.device_mesh = device_mesh
        self.placements = tuple(placements)

    def place(self, t):
        return _dtensor.place(t, self.device_mesh, self.placements)

    def __repr__(self) -> str:
        return f"Sharding({list(self.placements)})"


def named(mesh, spec_tree: Any) -> Any:
    """The placement of each spec's leaf: on a mesh of ranks a ``Sharding``,
    else the ``torch.device`` it lives on whole (the mesh's one physical
    device, ``mesh_device``). A tree of these is what
    ``checkpoint.restore(shardings=)`` takes."""
    if on_ranks(mesh):
        return tree_map(lambda s: Sharding(mesh.device_mesh, placements(mesh, s)), spec_tree, is_leaf=_is_spec)
    dev = mesh_device(mesh)
    return tree_map(lambda s: dev, spec_tree, is_leaf=_is_spec)


def place(mesh, spec_tree: Any, tree: Any) -> Any:
    """``tree`` laid out as ``spec_tree`` says on ``mesh``: DTensors on a
    mesh of ranks (from whole tensors or numpy arrays, alike on every rank,
    or DTensors), else every leaf moved to the mesh's device."""
    if not on_ranks(mesh):
        dev = mesh_device(mesh)
        return tree_map(lambda t: torch.as_tensor(t).to(dev), tree)
    return tree_map(lambda s, t: s.place(t), named(mesh, spec_tree), tree, is_leaf=lambda x: isinstance(x, Sharding))
