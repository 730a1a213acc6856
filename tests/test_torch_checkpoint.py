"""repro_torch.checkpoint against the reference's ``repro.checkpoint``.

The round trip and atomicity of ``tests/test_system.py`` on a tree of
tensors, the async save, and the format: on the same dict, nested-dict,
list and NamedTuple trees the port writes the reference's ``manifest.json``
and ``.npy`` files byte for byte, and each package restores the other's
checkpoint. ``restore`` puts the leaves back as tensors on ``device``, or
where ``shardings=`` places them: a mesh structure saved from an 8-shard
mesh restores onto a (2, 4) mesh with the same global leaves (the elastic
restore). A bfloat16 leaf goes to disk as the reference writes it, and the
reference's comes back as bfloat16; a training runner's checkpoint (params
and ``AdamWState``) written by either package resumes in the other.
Tolerance: exact, dtypes included; the resumed losses within 1e-5 (float32
in two packages, ``tests/test_torch_train_parity.py``).
"""

import json
import os
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro_torch import checkpoint
from repro_torch.core import distributed
from repro_torch.launch.mesh import make_mesh
from test_torch_train_parity import one_thread  # noqa: F401 (an autouse fixture)
from torch_parity_util import assert_same_structure, leaves, to_np

Pair = namedtuple("Pair", "w b")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "i32": rng.integers(-9, 9, 17).astype(np.int32),
        "i64": rng.integers(0, 1 << 40, 5).astype(np.int64),
        "u8": rng.integers(0, 255, 6).astype(np.uint8),
        "f64": np.float64(2.5) * np.ones((2, 2)),
        "flag": np.array([True, False]),
        "scalar": np.array(7, np.int32),
    }


# The same trees of numpy arrays for the reference and of tensors for the port.
TREES = {
    "dict": lambda a: {"x": a["f32"], "b_stw": a["i32"], "spec": a["u8"]},
    "nested": lambda a: {"params": {"w": a["f32"], "b": a["f64"]}, "opt": {"m": a["i64"], "t": a["scalar"]}},
    "list": lambda a: [a["i32"], [a["flag"], a["u8"]], (a["f32"],)],
    "namedtuple": lambda a: {"layer": Pair(w=a["f32"], b=a["i32"]), "step": a["i64"]},
}


def _tensors(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tensors(v) for v in tree))
    return type(tree)(_tensors(v) for v in tree)


def _flat(tree):
    return [to_np(a) for a in jax.tree_util.tree_leaves(tree, is_leaf=lambda v: isinstance(v, torch.Tensor))]


def _assert_trees_equal(a, b):
    la, lb = _flat(a), _flat(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y)


def test_checkpoint_roundtrip(tmp_path):
    tree = _tensors(TREES["nested"](_arrays()))
    checkpoint.save(str(tmp_path), 5, tree)
    restored = checkpoint.restore(str(tmp_path), 5, tree, device="cpu")
    assert isinstance(restored["params"]["w"], torch.Tensor)
    _assert_trees_equal(tree, restored)


def test_checkpoint_atomicity(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"p": torch.arange(4)})
    # a torn write (tmp dir) must be invisible to latest_step
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert checkpoint.latest_step(str(tmp_path)) == 1
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_async(tmp_path):
    checkpoint.save(str(tmp_path), 3, {"p": torch.ones(8)}, background=True)
    checkpoint.wait_pending()
    assert checkpoint.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("kind", sorted(TREES))
def test_checkpoint_files_match_the_reference(kind, tmp_path):
    """The same tree through both packages' ``save``: identical manifest and
    leaf files, and each package restores the other's checkpoint."""
    host = TREES[kind](_arrays(1))
    tree = _tensors(host)
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    jax_ckpt.save(str(ref_root), 4, host, meta={"engine": "hybrid", "seq": 4})
    checkpoint.save(str(port_root), 4, tree, meta={"engine": "hybrid", "seq": 4})
    a, b = ref_root / "step_00000004", port_root / "step_00000004"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "manifest.json" in names and len(names) == len(_flat(host)) + 1
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    _assert_trees_equal(host, checkpoint.restore(str(ref_root), 4, tree, device="cpu"))
    _assert_trees_equal(tree, jax_ckpt.restore(str(port_root), 4, host))


def test_snapshot_roundtrip_both_ways(tmp_path):
    arrays = {k: v for k, v in _arrays(2).items() if k != "scalar"}
    meta = {"engine": "sparse_table", "vid": 3, "n": 17, "dtype": "float32", "build_kw": {}, "seq": 3}
    checkpoint.save_snapshot(str(tmp_path / "port"), 3, arrays, meta)
    jax_ckpt.save_snapshot(str(tmp_path / "ref"), 3, arrays, meta)
    for root in ("port", "ref"):
        for load in (checkpoint.load_snapshot, jax_ckpt.load_snapshot):
            got, gmeta, step = load(str(tmp_path / root))
            assert step == 3 and gmeta == meta and sorted(got) == sorted(arrays)
            for k, v in arrays.items():
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v)
    with pytest.raises(FileNotFoundError):
        checkpoint.load_snapshot(str(tmp_path / "empty"))


def test_restore_places_leaves_on_the_device(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32), "b": [torch.zeros(2, dtype=torch.float64), None]}
    checkpoint.save(str(tmp_path), 0, tree)
    manifest = json.loads(Path(tmp_path, "step_00000000", "manifest.json").read_text())
    assert [e["key"] for e in manifest["leaves"]] == ["['a']", "['b'][0]"]  # None holds no leaf
    out = checkpoint.restore(str(tmp_path), 0, tree, device=torch.device("cpu"))
    assert out["b"][1] is None and out["a"].device.type == "cpu" and out["b"][0].dtype == torch.float64
    _assert_trees_equal(tree, out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            checkpoint.restore(str(tmp_path), 0, tree)  # default device: the card
    placed = checkpoint.restore(
        str(tmp_path), 0, tree, shardings={"a": torch.device("cpu"), "b": [torch.device("cpu"), None]}
    )
    _assert_trees_equal(tree, placed)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path), 0, tree, shardings={"a": torch.device("cpu"), "b": [None, None]})
    with pytest.raises(ValueError, match=r"\['c'\] where the tree has \['b'\]\[0\]"):  # same count, other keys
        checkpoint.restore(str(tmp_path), 0, tree, shardings={"a": torch.device("cpu"), "c": torch.device("cpu")})
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), 0, {"a": torch.zeros(5), "b": [torch.zeros(2)]}, device="cpu")


@pytest.mark.parametrize("engine", ["sharded_st", "distributed"])
def test_elastic_restore_onto_another_mesh(engine, tmp_path):
    """A mesh structure saved from an (8,) mesh restores onto a (2, 4) mesh
    through ``shardings=`` (``Placement`` per leaf, the port's
    ``NamedSharding``): the same global leaves, and the reference restores
    the same checkpoint to the same arrays."""
    x = np.random.default_rng(5).integers(0, 9, 4096).astype(np.float32)
    m8 = make_mesh((8,), ("shard",), devices="cpu")
    m24, axes = make_mesh((2, 4), ("data", "model"), devices="cpu"), ("data", "model")
    if engine == "sharded_st":
        tree = distributed.build_sharded_st(x, m8, ("shard",))
        place = distributed.ShardedSparseTable(*(distributed.Placement(m24, axes, 1),) * 2)
    else:
        tree = distributed.build_sharded(x, m8, ("shard",), 128)
        rows, cols = distributed.Placement(m24, axes, 0), distributed.Placement(m24, axes, 1)
        place = type(tree)(rows, rows, rows, type(tree.st)(cols, rows))
    checkpoint.save(str(tmp_path), 1, tree)
    out = checkpoint.restore(str(tmp_path), 1, tree, shardings=place)
    assert_same_structure(tree, out)
    for (_, a), (_, b) in zip(leaves(tree), leaves(out)):
        assert b.num_shards == 8 and b.dim == a.dim and b.copies[0].keys() == {torch.device("cpu")}
    host = jax.tree_util.tree_map(np.asarray, jax_ckpt.restore(str(tmp_path), 1, _host_like(tree)))
    for (_, a), b in zip(leaves(tree), jax.tree_util.tree_leaves(host)):
        np.testing.assert_array_equal(to_np(a), b)


def _host_like(tree):
    """``tree`` with numpy leaves, the reference's ``like``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(_host_like, tree))
    return np.asarray(tree)


# --- bfloat16 leaves and the training runner's checkpoints ----------------------


def _bf16_values():
    """float32 values exact in bfloat16, signed zeros and infinities too."""
    v = np.array([[1.0, -2.5, 3.0, 0.0], [-0.0, 1e30, -np.inf, 2.0 ** -120]], np.float32)
    return v.view(np.uint32) & np.uint32(0xFFFF0000)


def test_bf16_leaf_is_written_as_the_reference_writes_it(tmp_path):
    """A bfloat16 tensor saved by the port: the reference's ``.npy`` (its
    ``ml_dtypes`` words under ``'<V2'``) and manifest, byte for byte; the
    port restores it as bfloat16 with the same bits."""
    bits = _bf16_values()
    host = {"w": jnp.asarray(bits.view(np.float32), jnp.bfloat16), "n": np.arange(3, dtype=np.int32)}
    tree = {"w": torch.from_numpy(bits.view(np.float32)).bfloat16(), "n": torch.arange(3, dtype=torch.int32)}
    jax_ckpt.save(str(tmp_path / "ref"), 2, host)
    checkpoint.save(str(tmp_path / "port"), 2, tree)
    a, b = tmp_path / "ref" / "step_00000002", tmp_path / "port" / "step_00000002"
    for name in sorted(p.name for p in a.iterdir()):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    manifest = json.loads((b / "manifest.json").read_text())
    assert [e["dtype"] for e in manifest["leaves"]] == ["int32", "bfloat16"]
    back = checkpoint.restore(str(tmp_path / "port"), 2, tree, device="cpu")
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), tree["w"].view(torch.int16))


def test_reference_bf16_checkpoint_restores_as_bf16(tmp_path):
    bits = _bf16_values()
    jax_ckpt.save(str(tmp_path), 1, {"params": {"w": jnp.asarray(bits.view(np.float32), jnp.bfloat16)}})
    like = {"params": {"w": torch.zeros(bits.shape, dtype=torch.bfloat16)}}
    got = checkpoint.restore(str(tmp_path), 1, like, device="cpu")["params"]["w"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), (bits >> 16).astype(np.uint16))


@pytest.fixture(scope="module")
def qwen2_steps():
    """Reduced qwen2's train step in each package (B 2, L 16) and the
    reference's initial state, built once: the reference's compile is the
    cost."""
    from repro.launch.mesh import make_mesh as rmesh
    from repro.launch.mesh import set_mesh
    from repro.optim import adamw as radamw
    from repro.train.steps import make_train_step as rmake_train_step
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from test_torch_train_parity import reference_start

    rcfg, pcfg, params, opt = reference_start("qwen2-1.5b")
    mesh = rmesh((1, 1), ("data", "model"))
    rstep, _ = rmake_train_step(rcfg, mesh, lr_fn=radamw.cosine_schedule(1e-3, 1, 4), batch=2, seq_len=16)

    def in_mesh(*args):  # the reference's in-model sharding constraints need its mesh
        with set_mesh(mesh):
            return rstep(*args)

    pstep, _ = make_train_step(
        pcfg, make_mesh((1, 1), ("data", "model"), devices="cpu"),
        lr_fn=adamw.cosine_schedule(1e-3, 1, 4), batch=2, seq_len=16,
    )
    return {"reference": (in_mesh, rcfg), "port": (pstep, pcfg)}, params, opt


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_runner_checkpoint_resumes_in_the_other_package(writer, qwen2_steps, tmp_path):
    """Two steps of reduced qwen2 with a checkpoint of params and
    ``AdamWState`` at step 2, written by one package's runner; the other
    package's runner resumes it for steps 3 and 4, and its losses equal the
    writer's own resumed run within 1e-5."""
    import shutil

    from repro.train import runner as rrunner
    from repro_torch.train import runner as prunner
    from test_torch_train_parity import REL_LOSS, port_start

    steps, params, opt = qwen2_steps
    pp, po = port_start(params, opt)
    start = {"reference": (params, opt), "port": (pp, po)}

    def run(package, root, total):
        step_fn, cfg = steps[package]
        p, o = start[package]
        if package == "port":
            rc = prunner.RunnerConfig(total_steps=total, ckpt_dir=str(root), ckpt_every=2, seed=3)
            return prunner.run_training(step_fn, p, o, cfg, 2, 16, rc, device="cpu")
        rc = rrunner.RunnerConfig(total_steps=total, ckpt_dir=str(root), ckpt_every=2, seed=3)
        return rrunner.run_training(step_fn, p, o, cfg, 2, 16, rc)

    reader = "reference" if writer == "port" else "port"
    first = run(writer, tmp_path / "a", 2)
    assert first.steps_done == 2 and checkpoint.latest_step(str(tmp_path / "a")) == 2
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    own = run(writer, tmp_path / "a", 4)
    other = run(reader, tmp_path / "b", 4)
    assert own.steps_done == other.steps_done == 2
    for a, b in zip(other.losses, own.losses):
        assert abs(a - b) <= REL_LOSS * abs(b), (other.losses, own.losses)
