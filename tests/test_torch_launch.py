"""repro_torch.launch.sharding and launch.train against the reference.

The sharding cases of ``tests/test_launch.py`` run under their names on the
port for all ten configs; then every spec the port gives (``param_specs``,
``batch_specs`` of the three kinds, ``cache_spec``, ``opt_state_specs``)
equals the reference's ``PartitionSpec`` as a tuple, on a ``(1, 1)`` mesh
and on the production 16 x 16 shape (a stand-in with the mesh's axis
sizes, as the reference's test uses). ``named`` places leaves on the
mesh's one device; a mesh over several devices, or on ``meta``, cannot
run a step. The training CLI runs on the CPU with ``--device cpu --smoke``.
Tolerance: exact (specs are names).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as rget
from repro.launch import sharding as rsharding
from repro.launch.mesh import make_mesh as rmesh
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import sharding, train
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import Cache
from repro_torch.optim.adamw import AdamWState
from test_torch_train_parity import one_thread  # noqa: F401 (an autouse fixture)


class FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def _is_spec(x) -> bool:
    return isinstance(x, sharding.PartitionSpec)


# --- tests/test_launch.py, on the port ---------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_cover_every_leaf(arch):
    cfg = get_config(arch)
    mesh = make_mesh((1, 1), ("data", "model"), devices="cpu")
    shapes = model_lib.param_shapes(cfg)
    specs = sharding.param_specs(cfg, mesh)
    s_leaves = jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple))
    p_leaves = jax.tree.leaves(specs, is_leaf=_is_spec)
    assert len(s_leaves) == len(p_leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divisible_on_production_shape(arch):
    """Every sharded dim must divide by its axis size on a 16x16-shaped mesh."""
    cfg = get_config(arch)
    sizes = FakeMesh.shape
    flat_s = jax.tree_util.tree_flatten_with_path(
        model_lib.param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple)
    )[0]
    flat_p = jax.tree_util.tree_flatten_with_path(sharding.param_specs(cfg, FakeMesh), is_leaf=_is_spec)[0]
    assert len(flat_s) == len(flat_p)
    for (path_s, shape), (path_p, spec) in zip(flat_s, flat_p):
        assert path_s == path_p
        for dim, ax in zip(shape, tuple(spec)):
            if ax is None:
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            size = int(np.prod([sizes[a] for a in axes]))
            assert dim % size == 0, (path_s, shape, spec)


def test_cache_spec_long_context():
    """long_500k (batch=1): cache must shard seq over model, not batch."""
    spec = sharding.cache_spec(get_config("gemma3-12b"), FakeMesh, batch=1, capacity=524288)
    assert spec.k[2] == "model"  # seq dim
    assert spec.k[1] is None  # batch=1 unshardable


def test_dp_axes():
    single = make_mesh((1, 1), ("data", "model"), devices="cpu")
    assert sharding.dp_axes(single) == ("data",)


# --- parity with repro.launch.sharding ------------------------------------------


def _same(port, ref):
    """Spec trees equal: the same paths, each port spec the reference's as a tuple."""
    flat_p = jax.tree_util.tree_flatten_with_path(port, is_leaf=_is_spec)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda x: isinstance(x, JP))[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_p] == [jax.tree_util.keystr(k) for k, _ in flat_r]
    for (path, a), (_, b) in zip(flat_p, flat_r):
        assert _is_spec(a), path
        assert tuple(a) == tuple(b), (jax.tree_util.keystr(path), a, b)


@pytest.mark.parametrize("mesh_kind", ["1x1", "16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh_kind):
    cfg, rcfg = get_config(arch), rget(arch)
    if mesh_kind == "1x1":
        mesh, rm = make_mesh((1, 1), ("data", "model"), devices="cpu"), rmesh((1, 1), ("data", "model"))
    else:
        mesh = rm = FakeMesh
    pspecs = sharding.param_specs(cfg, mesh)
    rspecs = rsharding.param_specs(rcfg, rm)
    _same(pspecs, rspecs)
    opt = sharding.opt_state_specs(pspecs)
    assert isinstance(opt, AdamWState) and tuple(opt.step) == ()
    _same(opt, rsharding.opt_state_specs(rspecs))
    for batch, seq in ((256, 4096), (32, 32768), (1, 524288), (3, 128)):
        for kind in ("train", "prefill", "decode"):
            _same(sharding.batch_specs(cfg, mesh, batch, seq, kind), rsharding.batch_specs(rcfg, rm, batch, seq, kind))
        spec = sharding.cache_spec(cfg, mesh, batch, seq)
        assert isinstance(spec, Cache)
        _same(spec, rsharding.cache_spec(rcfg, rm, batch, seq))
        assert sharding.batch_axes(cfg, mesh, batch) == rsharding.batch_axes(rcfg, rm, batch)
    assert sharding.dp_axes(mesh) == rsharding.dp_axes(rm)


def test_fsdp_specs_match_reference():
    """``parallelism="fsdp"`` (no config sets it): the FSDP axis spans the
    mesh and the model axis leaves the weights."""
    import dataclasses

    cfg = dataclasses.replace(get_config("granite-3-8b"), parallelism="fsdp")
    rcfg = dataclasses.replace(rget("granite-3-8b"), parallelism="fsdp")
    _same(sharding.param_specs(cfg, FakeMesh), rsharding.param_specs(rcfg, FakeMesh))
    for batch in (256, 24, 1):
        _same(sharding.batch_specs(cfg, FakeMesh, batch, 64, "train"), rsharding.batch_specs(rcfg, FakeMesh, batch, 64, "train"))


def test_named_places_every_leaf_on_the_mesh_device():
    cfg = get_config("qwen2-1.5b")
    mesh = make_mesh((2, 4), ("data", "model"), devices="cpu")
    specs = sharding.opt_state_specs(sharding.param_specs(cfg, mesh))
    placed = sharding.named(mesh, specs)
    flat = jax.tree.leaves(placed, is_leaf=lambda x: isinstance(x, torch.device))
    assert len(flat) == len(jax.tree.leaves(specs, is_leaf=_is_spec))
    assert set(flat) == {torch.device("cpu")}
    with pytest.raises(NotImplementedError, match="one device"):
        sharding.named(make_mesh((2,), ("data",), devices=["cpu", "meta"]), specs)
    with pytest.raises(ValueError, match="meta"):
        sharding.named(make_production_mesh(), specs)


# --- the CLI --------------------------------------------------------------------


def test_train_cli_smoke_on_cpu(tmp_path, capsys):
    report = train.main([
        "--arch", "granite-3-8b", "--smoke", "--steps", "4", "--batch", "2", "--seq-len", "32",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "done: 4 steps" in out and "restarts 0 on cpu" in out
    assert report.steps_done == 4 and all(np.isfinite(report.losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]
    # a second run resumes from the last checkpoint: nothing left to do
    again = train.main([
        "--arch", "granite-3-8b", "--smoke", "--steps", "4", "--batch", "2", "--seq-len", "32",
        "--ckpt-dir", str(tmp_path), "--device", "cpu",
    ])
    assert again.steps_done == 0


def test_train_cli_refuses_what_it_cannot_train(tmp_path):
    with pytest.raises(ValueError, match="production-mesh"):
        train.main(["--arch", "qwen2-1.5b", "--smoke", "--production-mesh", "--ckpt-dir", str(tmp_path)])
    if not torch.cuda.is_available():  # the default device is the card: no CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main(["--arch", "qwen2-1.5b", "--smoke", "--ckpt-dir", str(tmp_path)])


def test_train_cli_default_ckpt_dir_is_the_checkouts(tmp_path, monkeypatch):
    """Without --ckpt-dir, a run checkpoints under the checkout's
    build/ckpt/<arch>[-smoke], one directory per config."""
    root = Path(__file__).resolve().parents[1]
    assert train.default_ckpt_dir("qwen2-1.5b", smoke=True) == root / "build" / "ckpt" / "qwen2-1.5b-smoke"
    assert train.default_ckpt_dir("qwen2-1.5b", smoke=False) == root / "build" / "ckpt" / "qwen2-1.5b"
    seen = []
    monkeypatch.setattr(train, "default_ckpt_dir", lambda arch, smoke: seen.append((arch, smoke)) or tmp_path / arch)
    train.main(["--arch", "granite-3-8b", "--smoke", "--steps", "2", "--batch", "2", "--seq-len", "32",
                "--ckpt-every", "2", "--device", "cpu"])
    assert seen == [("granite-3-8b", True)]
    assert [p.name for p in (tmp_path / "granite-3-8b").iterdir()] == ["step_00000002"]
