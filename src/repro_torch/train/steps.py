"""Step builders: train/prefill/serve steps for a mesh.

Port of ``repro/train/steps.py``. Each builder returns ``(call, specs)`` as
the reference does. A step runs on one of two kinds of mesh
(``launch/mesh.py``):

  * a mesh whose positions share one device (every position of a mesh on
    one card, or on the CPU): the step computes there, on whole tensors;
    the specs say where each leaf would live on a mesh of several devices;
  * a mesh of ranks, one process per device (``torch.distributed``): every
    param, optimizer and batch leaf is a DTensor laid out by the specs
    (``launch.sharding.place``), every rank calls the step, and DTensor's
    propagation plays the part of the reference's GSPMD. The step runs
    under ``implicit_replication``: the tensors the model makes inside its
    forward (rope tables, positions, masks, iotas) are alike on every rank
    and count as replicated, so the model keeps one code for both kinds.
    The outputs follow the reference's ``out_shardings``: params and
    optimizer state as their specs say, ``loss``, ``grad_norm`` and ``lr``
    plain tensors, alike on every rank.

A mesh of one process over several devices raises ``NotImplementedError``
(``launch.sharding.mesh_device``). What the mesh changes in the arithmetic
is the MoE grouping: ``_with_mesh_axes`` writes the mesh's axes into the
config, and an MoE layer then routes each data-parallel shard's tokens as
its own group, as the reference's does.

``make_train_step`` takes ``model.train_loss`` → ``backward`` →
``adamw.update``, with microbatch gradient accumulation (a Python loop
where the reference scans: float32 sums, divided by the count) and
optional stateless int8 gradient compression. The step is functional, as
the reference's is: it returns new params and state and leaves the ones
it was given as they were.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import _dtensor
from repro_torch._tree import leaves, tree_map
from repro_torch.launch import sharding as shard_rules
from repro_torch.models import model as model_lib
from repro_torch.models.layers import reference_matmul
from repro_torch.optim import adamw
from repro_torch.optim import compress as compress_lib

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step", "place_state", "TrainState", "value_and_grad"]


def _with_mesh_axes(cfg, mesh, batch: int | None = None):
    """Inject mesh axis names so in-model rules can refer to them (only
    when the mesh actually has a model axis)."""
    if cfg.parallelism == "fsdp":
        # pure FSDP: the batch owns every axis it divides; no TP/SP inside
        dp = shard_rules.batch_axes(cfg, mesh, batch) if batch else tuple(mesh.axis_names)
        return dataclasses.replace(
            cfg,
            mesh_dp=dp or (),
            mesh_model="",
            mesh_model_size=0,
            mesh_axis_sizes=tuple(mesh.shape.items()),
        )
    model_axis = "model" if "model" in mesh.axis_names else ""
    return dataclasses.replace(
        cfg,
        mesh_dp=shard_rules.dp_axes(mesh),
        mesh_model=model_axis,
        mesh_model_size=mesh.shape[model_axis] if model_axis else 0,
        mesh_axis_sizes=tuple(mesh.shape.items()),
    )


def _to(tree, dev: torch.device):
    return tree_map(lambda t: t.to(dev), tree)


def value_and_grad(params, batch_data, cfg):
    """(loss, grads): ``train_loss`` and its gradient with respect to every
    leaf of ``params`` (``None`` where the loss does not read a leaf). The
    backward pass, remat recomputation included, runs under the forward's
    matmul precision."""
    flat = leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with reference_matmul():
        loss = model_lib.train_loss(tree, batch_data, cfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(
    cfg,
    mesh,
    *,
    lr_fn,
    batch: int,
    seq_len: int,
    microbatches: int = 1,
    grad_compress: bool = False,
):
    """Returns (step, specs dict for inspection). ``step(params, opt_state,
    batch_data)`` returns ``(params, opt_state, {"loss", "grad_norm",
    "lr"})``, every tensor on the mesh's device."""
    cfg = _with_mesh_axes(cfg, mesh, batch)
    dev = shard_rules.step_device(mesh)
    pspecs = shard_rules.param_specs(cfg, mesh)
    ospecs = shard_rules.opt_state_specs(pspecs)
    bspecs = shard_rules.batch_specs(cfg, mesh, batch, seq_len, "train")
    if batch % microbatches:
        raise ValueError(f"batch {batch} does not split into {microbatches} microbatches")
    specs = {"params": pspecs, "opt": ospecs, "batch": bspecs}
    if shard_rules.on_ranks(mesh):
        return _rank_train_step(cfg, mesh, specs, lr_fn, batch, seq_len, microbatches, grad_compress), specs

    def step(params, opt_state, batch_data):
        batch_data = _to(batch_data, dev)
        if microbatches > 1:
            m = batch // microbatches
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                mb = tree_map(lambda x: x[i * m : (i + 1) * m], batch_data)
                l, g = value_and_grad(params, mb, cfg)
                gsum = tree_map(lambda a, b: a if b is None else a + b.to(torch.float32), gsum, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        else:
            loss, grads = value_and_grad(params, batch_data, cfg)

        if grad_compress:
            # the stateless variant (int8 + error feedback with carried
            # residuals is ``compress.ef_compress_grads``, wired by a caller)
            grads = tree_map(lambda _, g: _compressed(g), params, grads)

        params, opt_state, metrics = adamw.update(grads, opt_state, lr_fn=lr_fn, param_dtype=cfg.param_dtype)
        return params, opt_state, {"loss": loss, **metrics}

    return step, specs


def _replicating():
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _compressed(g):
    return None if g is None else compress_lib.decompress(*compress_lib.compress(g))


def _rank_train_step(cfg, mesh, specs, lr_fn, batch, seq_len, microbatches, grad_compress):
    """``make_train_step``'s step on a mesh of ranks (module docstring). The
    microbatches are cut from the whole batch and each laid out by the
    specs of its own size; every gradient is laid out as its param before
    it is summed or used, so the update runs leafwise on local shards."""
    pspecs, ospecs, bspecs = specs["params"], specs["opt"], specs["batch"]
    m = batch // microbatches
    mspecs = shard_rules.batch_specs(cfg, mesh, m, seq_len, "train")

    def grads_of(params, data, bspec):
        loss, grads = value_and_grad(params, shard_rules.place(mesh, bspec, data), cfg)
        grads = tree_map(lambda p, g: None if g is None else g.redistribute(p.device_mesh, p.placements), params, grads)
        return loss, grads

    def step(params, opt_state, batch_data):
        with _replicating():
            if microbatches > 1:
                whole = tree_map(_dtensor.full, batch_data)
                gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
                lsum = torch.zeros((), dtype=torch.float32, device=mesh.rank_device)
                for i in range(microbatches):
                    l, g = grads_of(params, tree_map(lambda x: x[i * m : (i + 1) * m], whole), mspecs)
                    gsum = tree_map(lambda a, b: a if b is None else a + b.to(torch.float32), gsum, g)
                    lsum = lsum + l
                grads = tree_map(lambda g: g / microbatches, gsum)
                loss = lsum / microbatches
            else:
                loss, grads = grads_of(params, batch_data, bspecs)
            if grad_compress:
                grads = tree_map(lambda _, g: _compressed(g), params, grads)
            params, opt_state, metrics = adamw.update(grads, opt_state, lr_fn=lr_fn, param_dtype=cfg.param_dtype)
            params = shard_rules.place(mesh, pspecs, params)
            opt_state = shard_rules.place(mesh, ospecs, opt_state)
            out = {"loss": loss, **metrics}
            return params, opt_state, {k: _dtensor.full(v) for k, v in out.items()}

    return step


def make_prefill_step(cfg, mesh, *, batch: int, seq_len: int):
    """Returns (step, specs): ``step(params, inputs)`` is ``model.prefill``
    on the mesh's device with the mesh's axes in the config."""
    cfg = _with_mesh_axes(cfg, mesh, batch)
    dev = shard_rules.step_device(mesh)
    pspecs = shard_rules.param_specs(cfg, mesh)
    ispec = shard_rules.batch_specs(cfg, mesh, batch, seq_len, "prefill")
    cspecs = shard_rules.cache_spec(cfg, mesh, batch, seq_len + cfg.cache_pad)

    specs = {"params": pspecs, "input": ispec, "cache": cspecs}
    if shard_rules.on_ranks(mesh):
        lspec = _logits_spec(cfg, mesh, batch)

        def rank_step(params, inputs):
            with _replicating():
                logits, cache = model_lib.prefill(params, shard_rules.place(mesh, ispec, inputs), cfg)
                return shard_rules.place(mesh, lspec, logits), _place_cache(mesh, cspecs, cache)

        return rank_step, specs

    def step(params, inputs):
        return model_lib.prefill(params, inputs.to(dev), cfg)

    return step, specs


def make_serve_step(cfg, mesh, *, batch: int, capacity: int):
    """One-token decode step against a capacity-sized cache (used up by the
    call, as ``model.decode_step``'s is)."""
    cfg = _with_mesh_axes(cfg, mesh, batch)
    dev = shard_rules.step_device(mesh)
    pspecs = shard_rules.param_specs(cfg, mesh)
    tspec = shard_rules.batch_specs(cfg, mesh, batch, 1, "decode")
    cspecs = shard_rules.cache_spec(cfg, mesh, batch, capacity)

    specs = {"params": pspecs, "token": tspec, "cache": cspecs}
    if shard_rules.on_ranks(mesh):
        lspec = _logits_spec(cfg, mesh, batch)

        def rank_step(params, token, cache):
            with _replicating():
                logits, cache = model_lib.decode_step(
                    params, shard_rules.place(mesh, tspec, token), _place_cache(mesh, cspecs, cache), cfg
                )
                return shard_rules.place(mesh, lspec, logits), _place_cache(mesh, cspecs, cache)

        return rank_step, specs

    def step(params, token, cache):
        return model_lib.decode_step(params, token.to(dev), cache, cfg)

    return step, specs


def _logits_spec(cfg, mesh, batch: int):
    """The reference's ``out_shardings`` for a step's logits: batch over
    its axes, vocab over ``model``."""
    vdim = "model" if (cfg.parallelism != "fsdp" and "model" in mesh.axis_names) else None
    return shard_rules._guard(
        (batch, 1, cfg.padded_vocab), (shard_rules.batch_axes(cfg, mesh, batch), None, vdim), mesh
    )


def _place_cache(mesh, cspecs, cache):
    """A decode cache laid out as ``cache_spec`` says; ``length`` stays a
    number on the host."""
    fields = {f: shard_rules.place(mesh, getattr(cspecs, f), t) for f, t in cache._asdict().items()
              if f != "length" and t is not None}
    return cache._replace(**fields)


def _check_tree(tree, specs, what: str) -> None:
    """Raise unless ``tree``'s leaves sit where ``specs``' do."""
    is_spec = lambda x: isinstance(x, shard_rules.PartitionSpec)
    try:
        tree_map(lambda s, t: None, specs, tree, is_leaf=is_spec)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"{what} does not match the step's specs: {e!r}") from None
    n_specs, n_leaves = len(leaves(specs, is_spec)), len(leaves(tree))
    if n_specs != n_leaves:
        raise ValueError(f"{what} has {n_leaves} leaves, the step's specs {n_specs}")


def place_state(mesh, specs: dict, params, opt_state=None):
    """Put params (and opt state) where a step was built to find them,
    after checking that their trees match the step's specs: on the mesh's
    device, or, on a mesh of ranks, as DTensors laid out by the specs (from
    whole trees of tensors or numpy arrays, alike on every rank; carry the
    reference's state across with ``convert.model_params`` and
    ``convert.opt_state`` first)."""
    _check_tree(params, specs["params"], "params")
    params = shard_rules.place(mesh, specs["params"], params)
    if opt_state is None:
        return params
    _check_tree(opt_state, specs["opt"], "opt_state")
    return params, shard_rules.place(mesh, specs["opt"], opt_state)


class TrainState:
    """Params, optimizer state and step count in one object, for a caller
    that keeps them together (the reference's counterpart)."""

    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step
