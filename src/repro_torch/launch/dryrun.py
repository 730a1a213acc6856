"""Dry run: walk every (arch × shape) cell's step on the production meshes,
on torch's ``meta`` device, and extract roofline terms.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell for 512 fake XLA devices and reads XLA's cost and memory analyses and
the partitioned HLO's collectives. The port has no compiler and no SPMD
partitioner, so each reading has its own design here:

* **The step.** ``lower_step`` builds the cell's step with the trainer's
  own builders (``train.steps.make_train_step`` / ``make_prefill_step`` /
  ``make_serve_step``) on the production mesh, whose positions are all on
  ``meta``: the step then computes on meta tensors, shapes and dtypes
  without bytes. The inputs are ``launch.specs.input_specs_for``'s; a
  decode cell's cache keeps its length on the host, one below its capacity
  (a full-context decode step; the cost does not depend on the length).
* **The counts.** ``_measure`` runs the step once under one counting
  ``TorchDispatchMode`` (``_Counter``):
    - ``flops``: 2·m·n·k per product, by ``torch.utils.flop_counter``'s
      formulas, plus, as XLA's cost analysis counts them, one per output
      element of each elementwise floating-point op (a dtype conversion
      included; the transcendentals, which XLA counts apart, not) and one
      per input element of each floating-point reduction;
    - ``bytes``: each op's input and output bytes, views not counted. This
      is the eager port's own unfused traffic: it is 1.2-2.1x XLA's fused
      "bytes accessed" on one device (tests/test_torch_dryrun.py);
    - ``temp``: the peak of live bytes among the tensors the step creates,
      each tracked by a weakref finalizer;
  and raises if an op yields a tensor off ``meta``, but for a CPU tensor
  of at most one element (a host scalar such as ``models.layers.scalar``
  makes, or the empty placeholder ``torch.utils.checkpoint`` makes in some
  torch versions). Nothing is allocated on any device and CUDA is never
  initialised.
* **Per device.** Flops, bytes and temp are divided by the mesh's positions
  (an ideal partition). Argument and output bytes are exact: each leaf's
  bytes divided by the product of the mesh axes its ``PartitionSpec``
  shards it over (``launch.sharding``'s specs).
* **Collectives** (``collective_model``) are an analytic model over those
  specs, in result bytes per device as ``roofline.collective_bytes`` reads
  them from an HLO; "passes" is 2 for a train step (forward and backward)
  and 1 otherwise:
    - all-gather: each parameter leaf that a data-parallel axis shards, made
      whole over those axes (its model-axis shard), once per pass;
    - reduce-scatter (train): each such leaf's gradient, to its shard;
    - all-reduce (train): each gradient that a data-parallel axis
      replicates, at its shard's size;
    - with a model axis (tensor parallelism), the activations (tokens per
      data-parallel shard × d_model, "act") of each attention, FFN/MoE and
      SSM block, of the vocab-sharded embedding lookup and, in a train step,
      of the unembedding: with ``seq_parallel`` (Megatron's sequence
      parallelism, every config's setting) an all-gather of act and a
      reduce-scatter to act / model size in the forward pass, two more
      all-gathers and a reduce-scatter in the backward; without it an
      all-reduce of act per pass;
    - all-gather: with a model axis that the KV heads do not divide, or a
      config that shards attention over the sequence (``attn_shard="seq"``),
      each attention layer's K and V, once per pass;
    - all-to-all: an MoE layer whose experts the model axis shards (expert
      parallelism) sends its dispatched tokens (tokens × top_k × capacity
      factor × d_model) out and back, once per pass;
    - all-reduce (decode): attention over a cache that the model axis
      shards along the sequence combines its float32 partial outputs.
  A mesh of one position gives 0. Against the reference's partitioned HLO
  on a (2, 4) mesh the model's total is within 2x (the test holds it);
  XLA there gathers weights whole rather than reduce activations.

The roofline terms take the full-depth walk's counts: the port runs no
scan (its layers are a Python loop), so the walk counts every layer, where
XLA counts a loop body once and the reference must extrapolate.
``cost_extrapolate`` still does as the reference's: ``layer_types`` gives
each arch's layer types, 1 and 2 layers of each are walked, ``c(2) - c(1)``
is a layer's cost and the rest the base; ``cost_detail`` keeps that
breakdown and its total (under "extrapolated"). The two agree exactly on a
forward step (the tests hold them equal). A train step's walk counts more:
each layer takes its slice of a stacked leaf (``v[i]``), autograd turns
each slice's gradient into a full-size one and sums the L of them, which
is (L-1)(L-2)·w elementwise flops beyond the extrapolation for w
parameters per layer. The full-depth walk is also the shape proof, all
that ``--compile-only`` runs. ``--out`` defaults to ``build/dryrun`` in the
working directory, where the reference writes ``experiments/dryrun``. The
terms for 256 and 512 GPUs are a plan, computed here, not a measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --all --mesh multi --compile-only   # shape proof only
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch._tree import leaves, tree_map
from repro_torch.configs import cells, get_config
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch import sharding as shard_rules
from repro_torch.launch.mesh import make_production_mesh, set_mesh
from repro_torch.launch.specs import input_specs_for, model_flops, shape_config
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step

__all__ = [
    "Lowered",
    "lower_step",
    "layer_types",
    "cost_extrapolate",
    "collective_model",
    "run_cell",
    "main",
]


class Lowered(NamedTuple):
    """A cell's step, ready to walk: ``step(*inputs())`` runs it once on
    fresh meta inputs (``input_specs_for``'s, an optimizer state added for
    a train step); ``specs`` are the inputs' ``PartitionSpec`` trees, in
    order, and ``out_specs(out)`` the output's."""

    step: Callable
    inputs: Callable[[], tuple]
    specs: tuple
    out_specs: Callable[[object], tuple]


def _f32(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32, device="meta"), tree)


def lower_step(cfg, shape_name, mesh, *, lr: float = 1e-4) -> Lowered:
    """The cell's step against meta stand-ins of its inputs; ``shape_name``
    names one of ``SHAPES`` or is a ``ShapeConfig`` of its own."""
    shape = shape_config(shape_name)
    logits = shard_rules.P(shard_rules.batch_axes(cfg, mesh, shape.global_batch), None, None)

    if shape.kind == "train":

        def inputs():
            specs = input_specs_for(cfg, shape_name)
            opt = adamw.AdamWState(
                step=torch.empty((), dtype=torch.int32, device="meta"),
                master=_f32(specs["params"]),
                mu=_f32(specs["params"]),
                nu=_f32(specs["params"]),
            )
            return specs["params"], opt, specs["batch"]

        step, sp = make_train_step(
            cfg, mesh,
            lr_fn=adamw.cosine_schedule(lr, 100, 10_000),
            batch=shape.global_batch, seq_len=shape.seq_len,
        )
        metrics = lambda out: tree_map(lambda _: shard_rules.P(), out[2])
        return Lowered(step, inputs, (sp["params"], sp["opt"], sp["batch"]),
                       lambda out: (sp["params"], sp["opt"], metrics(out)))

    if shape.kind == "prefill":

        def inputs():
            specs = input_specs_for(cfg, shape_name)
            return specs["params"], specs["inputs"]

        step, sp = make_prefill_step(cfg, mesh, batch=shape.global_batch, seq_len=shape.seq_len)
        return Lowered(step, inputs, (sp["params"], sp["input"]), lambda out: (logits, sp["cache"]))

    def inputs():
        # the cache's length on the host, one below its capacity
        specs = input_specs_for(cfg, shape_name)
        return specs["params"], specs["token"], specs["cache"]._replace(length=shape.seq_len - 1)

    step, sp = make_serve_step(cfg, mesh, batch=shape.global_batch, capacity=shape.seq_len)
    return Lowered(step, inputs, (sp["params"], sp["token"], sp["cache"]), lambda out: (logits, sp["cache"]))


# --------------------------------------------------------------------------
# the counter
# --------------------------------------------------------------------------

_aten = torch.ops.aten
# the ops XLA's cost analysis counts as transcendentals, not flops
_TRANSCENDENTAL = {
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log1p, _aten.log2, _aten.log10,
    _aten.sigmoid, _aten.pow, _aten.rsqrt, _aten.sqrt, _aten.tanh, _aten.sin, _aten.cos,
    _aten.tan, _aten.erf, _aten.atan2,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts flops, bytes and the peak of live created bytes of every op
    run under it (see the module docstring); raises on an output off
    ``meta``."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._products = flop_registry
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            if t.device.type != "meta" and not (t.device.type == "cpu" and t.numel() <= 1):
                raise RuntimeError(f"the dry run left the meta device: {func} gave a tensor on {t.device}")
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        packet = func.overloadpacket
        if packet in self._products:
            self.flops += self._products[packet](*args, **kwargs, out_val=out)
        elif outs and outs[0].is_floating_point():
            if torch.Tag.pointwise in func.tags and packet not in _TRANSCENDENTAL:
                self.flops += outs[0].numel()
            elif torch.Tag.reduction in func.tags and ins:
                self.flops += ins[0].numel()
            elif packet is _aten._to_copy and ins and ins[0].dtype != outs[0].dtype:
                self.flops += outs[0].numel()
        views = any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)
        if not views:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            written = {id(t) for t in ins}
            for t in outs:
                if id(t) not in written:  # a new tensor, not an in-place op's input
                    n = _nbytes(t)
                    self.live += n
                    weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


def _axes(entry) -> tuple:
    """The mesh axes of one ``PartitionSpec`` entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_axes(spec) -> list:
    return [a for entry in spec for a in _axes(entry)]


def _spec_factor(spec, mesh) -> int:
    """The product of the mesh axes a ``PartitionSpec`` shards over."""
    return math.prod(mesh.shape[a] for a in _spec_axes(spec))


def _is_spec(x) -> bool:
    return isinstance(x, shard_rules.PartitionSpec)


def _bytes_per_dev(tree, specs, mesh) -> int:
    """Σ each leaf's bytes over its shard factor (a host int leaf, a
    cache's length, is an int32 scalar, as the reference's spec holds it)."""

    def one(spec, leaf):
        if leaf is None:
            return 0
        n = _nbytes(leaf) if isinstance(leaf, torch.Tensor) else 4
        return n // _spec_factor(spec, mesh)

    return sum(leaves(tree_map(one, specs, tree, is_leaf=_is_spec)))


# --------------------------------------------------------------------------
# the collective model
# --------------------------------------------------------------------------


def collective_model(cfg, shape_name, mesh) -> dict:
    """Per-device result bytes per collective kind for the cell's step on
    ``mesh`` (the rules: the module docstring)."""
    shape = shape_config(shape_name)
    train = shape.kind == "train"
    passes = 2 if train else 1
    out: dict[str, float] = {}

    def add(kind: str, n: float) -> None:
        if n:
            out[kind] = out.get(kind, 0.0) + float(n)

    # parameters: FSDP gathers, gradient reductions
    psize = torch.empty((), dtype=cfg.param_dtype).element_size()
    dp = tuple(mesh.axis_names) if cfg.parallelism == "fsdp" else shard_rules.dp_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    pshapes = leaves(model_lib.param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))
    pspecs = leaves(shard_rules.param_specs(cfg, mesh), is_leaf=_is_spec)
    for pshape, spec in zip(pshapes, pspecs):
        w = math.prod(pshape) * psize
        on = _spec_axes(spec)
        s = math.prod(mesh.shape[a] for a in on)
        s_dp = math.prod(mesh.shape[a] for a in on if a in dp)
        if s_dp > 1:
            add("all-gather", passes * w * s_dp / s)
            if train:
                add("reduce-scatter", w / s)
        if train and dp_size > s_dp:
            add("all-reduce", w / s)

    # activations
    b_axes = shard_rules.batch_axes(cfg, mesh, shape.global_batch)
    n_b = math.prod(mesh.shape[a] for a in b_axes) if b_axes else 1
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    t_dp = tokens / n_b
    asize = torch.empty((), dtype=cfg.dtype).element_size()
    act = t_dp * cfg.d_model * asize
    tp = 1 if cfg.parallelism == "fsdp" else mesh.shape.get("model", 1)
    fam = cfg.family
    n_attn = cfg.num_layers if fam in ("dense", "moe", "vlm", "audio") else (
        cfg.num_layers // cfg.attn_every if fam == "hybrid" else 0)
    n_ssm = cfg.num_layers if fam in ("ssm", "hybrid") else 0
    n_moe = cfg.num_layers if cfg.num_experts else 0
    if tp > 1:
        blocks = 2 * n_attn + n_ssm + (n_moe if cfg.dense_residual else 0)
        blocks += (0 if cfg.embeds_input else 1) + (1 if train else 0)
        if cfg.seq_parallel:
            # Megatron sequence parallelism: a block gathers its input over
            # the sequence and reduce-scatters its output; the backward pass
            # gathers the output's gradient and the input again (for the
            # weight gradient) and reduce-scatters the input's gradient
            add("all-gather", blocks * (3 if train else 1) * act)
            add("reduce-scatter", blocks * passes * act / tp)
        else:
            add("all-reduce", blocks * passes * act)
        if n_attn and (cfg.attn_shard == "seq" or cfg.num_kv_heads % tp):
            add("all-gather", passes * n_attn * 2 * t_dp * cfg.num_kv_heads * cfg.head_dim * asize)
        if n_moe and cfg.num_experts % tp == 0:
            dispatched = t_dp * cfg.top_k * cfg.capacity_factor * cfg.d_model * asize
            add("all-to-all", passes * n_moe * 2 * dispatched)
        if shape.kind == "decode" and n_attn:
            cspec = shard_rules.cache_spec(cfg, mesh, shape.global_batch, shape.seq_len)
            if "model" in _axes(cspec.k[2]):
                add("all-reduce", n_attn * t_dp * cfg.num_heads * cfg.head_dim * 4)
    return out


# --------------------------------------------------------------------------
# layer-type decomposition for cost extrapolation
# --------------------------------------------------------------------------


def _unrolled(cfg, n):
    return dataclasses.replace(
        cfg, num_layers=n, unroll_layers=True, attn_unroll=True, ssm_unroll=True
    )


def layer_types(arch: str):
    """[(name, build_cfg(k_layers), count)] per arch (see module docstring)."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        ssm_like = dataclasses.replace(cfg, family="ssm", attn_every=0)
        attn_like = dataclasses.replace(
            cfg, family="dense", attn_every=0, ssm_state=0
        )
        n_seg = cfg.num_layers // cfg.attn_every
        return [
            ("mamba", lambda k: _unrolled(ssm_like, k), cfg.num_layers),
            ("shared_attn", lambda k: _unrolled(attn_like, k), n_seg),
        ]
    if cfg.global_every:
        local = dataclasses.replace(cfg, global_every=0)
        glob = dataclasses.replace(cfg, global_every=0, sliding_window=0)
        n_glob = cfg.num_layers // cfg.global_every
        return [
            ("local", lambda k: _unrolled(local, k), cfg.num_layers - n_glob),
            ("global", lambda k: _unrolled(glob, k), n_glob),
        ]
    return [("layer", lambda k: _unrolled(cfg, k), cfg.num_layers)]


def _measure(cfg, shape_name, mesh):
    """One counted walk of the cell's step: per-device flops, bytes and
    collective bytes (and their kinds), temp, argument and output bytes."""
    lowered = lower_step(cfg, shape_name, mesh)
    args = lowered.inputs()
    counter = _Counter()
    with counter:
        out = lowered.step(*args)
    coll = collective_model(cfg, shape_name, mesh)
    return {
        "flops": counter.flops / mesh.size,
        "bytes": counter.bytes / mesh.size,
        "coll": float(sum(coll.values())),
        "coll_breakdown": coll,
        "temp": counter.peak / mesh.size,
        "arg": _bytes_per_dev(args, lowered.specs, mesh),
        "out": _bytes_per_dev(tuple(out), lowered.out_specs(out), mesh),
    }


def cost_extrapolate(arch: str, shape_name: str, mesh) -> dict:
    total = {"flops": 0.0, "bytes": 0.0, "coll": 0.0}
    base = None
    detail = {}
    for i, (name, mk, count) in enumerate(layer_types(arch)):
        c1 = _measure(mk(1), shape_name, mesh)
        c2 = _measure(mk(2), shape_name, mesh)
        delta = {k: c2[k] - c1[k] for k in total}
        detail[name] = {"per_layer": delta, "count": count}
        if i == 0:
            base = {k: max(c1[k] - delta[k], 0.0) for k in total}
        for k in total:
            total[k] += count * delta[k]
    for k in total:
        total[k] += base[k]
    detail["base"] = base
    return {"total": total, "detail": detail}


# --------------------------------------------------------------------------
# cell runner
# --------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str | None,
             *, compile_only: bool = False):
    multi = mesh_name == "multi"
    mesh = make_production_mesh(multi_pod=multi)
    chips = 512 if multi else 256
    cfg = get_config(arch)
    t0 = time.time()
    with set_mesh(mesh):
        # 1) the full-depth walk: the shape proof; the counts, temp,
        # argument and output bytes, and the collectives of the whole step
        full = _measure(cfg, shape_name, mesh)
        t1 = time.time()

        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
            "compile_s": round(t1 - t0, 1),
            "temp_bytes_per_dev": full["temp"],
            "arg_bytes_per_dev": full["arg"],
            "out_bytes_per_dev": full["out"],
            "coll_schedule_scan_artifact": full["coll_breakdown"],
        }

        # 2) the roofline terms, from the full-depth walk; the reference's
        # extrapolation into cost_detail
        if not compile_only:
            est = cost_extrapolate(arch, shape_name, mesh)
            rl = roofline_lib.roofline_terms(
                arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
                cost={"flops": full["flops"], "bytes accessed": full["bytes"]},
                hlo_text="",  # collective bytes supplied below
                model_flops=model_flops(arch, shape_name),
                bytes_per_device=rec["temp_bytes_per_dev"],
            )
            rl.coll_bytes_per_dev = full["coll"]
            rl.coll_breakdown = full["coll_breakdown"]
            rl.t_collective = full["coll"] / roofline_lib.HW["ici_bw"]
            terms = {
                "compute": rl.t_compute, "memory": rl.t_memory,
                "collective": rl.t_collective,
            }
            rl.bottleneck = max(terms, key=terms.get)
            rec.update(rl.to_dict())
            rec["cost_detail"] = {**est["detail"], "extrapolated": est["total"]}

    if not compile_only:
        print(
            f"[{arch} × {shape_name} × {mesh_name}] OK walk={rec['compile_s']}s "
            f"flops/dev={rec['hlo_flops']:.3e} bytes/dev={rec['hlo_bytes']:.3e} "
            f"coll/dev={rec['coll_bytes_per_dev']:.3e} "
            f"t=(c {rec['t_compute']*1e3:.2f} | m {rec['t_memory']*1e3:.2f} | "
            f"x {rec['t_collective']*1e3:.2f}) ms bottleneck={rec['bottleneck']} "
            f"useful={rec['useful_ratio']:.2f} temp/dev={_fmt_bytes(rec['temp_bytes_per_dev'])}"
        )
    else:
        print(
            f"[{arch} × {shape_name} × {mesh_name}] WALK OK "
            f"({rec['compile_s']}s, temp/dev={_fmt_bytes(rec['temp_bytes_per_dev'])}, "
            f"colls={sorted(rec['coll_schedule_scan_artifact'])})"
        )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "compileonly" if compile_only else "full"
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}__{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def _fmt_bytes(b):
    if b is None:
        return "?"
    return f"{b/2**30:.2f}GiB"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--compile-only", action="store_true",
                    help="skip cost extrapolation (the full-depth walk only: the shape proof)")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s) for a, s, skipped in cells() if not skipped]
    else:
        todo = [(args.arch, args.shape)]

    failures = []
    for arch, shape in todo:
        for m in meshes:
            try:
                run_cell(arch, shape, m, args.out, compile_only=args.compile_only)
            except Exception as e:
                failures.append((arch, shape, m, repr(e)))
                traceback.print_exc()
    if failures:
        print(f"FAILED {len(failures)} cells:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"all {len(todo) * len(meshes)} dry-run cells passed")


if __name__ == "__main__":
    main()
