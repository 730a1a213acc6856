"""repro_torch's LM training on a mesh of ranks against the reference's mesh.

One module-scoped fixture starts three children at once:

  * the reference on a (2, 2) mesh of 4 fake XLA devices (as
    ``tests/test_torch_train.py``'s ``sharded_train_child`` runs it): three
    train steps of reduced granite and of reduced grok (capacity factor 1.0,
    two MoE groups) from the port's initial params (``init.npz``), and the
    index maps of ``NamedSharding`` for every placement case of
    ``tests/torch_ranks_job.py``;
  * the port on four gloo ranks (``tests/torch_ranks_job.py``), one process
    per rank, DTensor leaves: the same cases and steps, grok with 3 experts
    (F sharded over the model axis) and mamba2, checkpoints, ``run_training`` through
    a fault, and prefill and decode;
  * ``torchrun`` with two gloo ranks training the CLI's reduced granite.

The tests then hold (a) every rank's shard of every leaf of the ten
reduced configs on (2, 2) and (1, 4), pure FSDP on (2, 2) and a (2, 2, 1)
pod mesh to the block the reference's ``PartitionSpec`` gives that
position, exactly; (b) the ranks' three steps to the reference's and to
the port's one-device step (the 3-expert grok and mamba2 to the
one-device step alone), with the tolerances and helpers of
``tests/test_torch_train_parity.py`` at its batch shape (its docstring says
why each); (c) the ranks' checkpoint restored bit for bit by the
one-device port and by ``repro.checkpoint.restore``, and a fault replayed
on the ranks; prefill and decode on the ranks against whole tensors; (d)
the ``torchrun`` run: rank 0 reports, the loss falls.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as rrestore
from repro_torch import checkpoint, convert
from repro_torch.configs import ARCH_IDS
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step
from test_torch_train_parity import (  # noqa: F401
    REL, REL_LOSS, assert_state_close, grad_ratios, np_tree, one_thread, rel,
)
from torch_ranks_job import (
    B, L, LR, RANK_TRAINED, STEPS, TRAINED, VARIANTS, flat, nest, placement_cases, trained_config,
)

ROOT = Path(__file__).resolve().parents[1]

_CHILD_REFERENCE = textwrap.dedent(
    """
    import dataclasses, json, sys
    from pathlib import Path
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import get_config, reduce_for_smoke
    from repro.data import pipeline
    from repro.launch import sharding
    from repro.launch.mesh import make_mesh, set_mesh
    from repro.models import model
    from repro.optim import adamw
    from repro.train.steps import make_train_step, place_state
    sys.path.insert(0, sys.argv[2])
    from torch_ranks_job import B, L, LR, STEPS, TRAINED, flat, nest, placement_cases

    out = Path(sys.argv[1])
    maps = {}
    for name, arch, shape, axes, parallelism in placement_cases():
        cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), parallelism=parallelism)
        mesh = make_mesh(shape, axes)
        specs = flat(sharding.param_specs(cfg, mesh))
        for k, s in flat(model.param_shapes(cfg)).items():
            idx = NamedSharding(mesh, specs[k]).devices_indices_map(tuple(s))
            maps[f"{name}/{k}"] = [[[sl.start or 0, n if sl.stop is None else sl.stop] for sl, n in zip(idx[d], s)]
                                   for d in mesh.devices.flat]
    (out / "reference_maps.json").write_text(json.dumps(maps))

    init = dict(np.load(out / "init.npz"))
    arrays = {}
    for arch in TRAINED:
        cfg = reduce_for_smoke(get_config(arch))
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=1.0)
        mesh = make_mesh((2, 2), ("data", "model"))
        with set_mesh(mesh):
            params = jax.tree.map(jnp.asarray, nest(init, arch + "/"))
            opt = adamw.init(params)
            step, info = make_train_step(cfg, mesh, lr_fn=adamw.cosine_schedule(*LR), batch=B, seq_len=L)
            params, opt = place_state(mesh, info, params, opt)
            metrics = []
            for i in range(STEPS):
                params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, B, L, seed=0, step=i))
                metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
                arrays.update({f"{arch}/mu{i}/{k}": np.asarray(v) for k, v in flat(opt.mu).items()})
        arrays[f"{arch}/metrics"] = np.array(metrics, np.float64)
        arrays[f"{arch}/o/step"] = np.asarray(opt.step)
        for f in ("master", "mu", "nu"):
            arrays.update({f"{arch}/o/{f}/{k}": np.asarray(v) for k, v in flat(getattr(opt, f)).items()})
    np.savez(out / "reference.npz", **arrays)
    print("REFERENCE_OK")
    """
)


def _torchrun(ckpt: Path) -> list:
    """(d): ``torchrun`` with two gloo ranks training the CLI's reduced granite."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
            "-m", "repro_torch.launch.train", "--device", "cpu", "--arch", "granite-3-8b", "--smoke",
            "--steps", "6", "--batch", "4", "--seq-len", "32", "--lr", "1e-2", "--ckpt-every", "3",
            "--ckpt-dir", str(ckpt)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two children and ``torchrun``, started together; their outputs'
    directory (``torchrun.out`` holds the CLI's standard output)."""
    out = tmp_path_factory.mktemp("ranks")
    init = {}
    for arch in RANK_TRAINED:
        cfg = trained_config(arch)
        params = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        init.update({f"{arch}/{k}": v.numpy() for k, v in flat(params).items()})
    np.savez(out / "init.npz", **init)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = [
        (subprocess.Popen([sys.executable, "-c", _CHILD_REFERENCE, str(out), str(ROOT / "tests")],
                          env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), "REFERENCE_OK"),
        (subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_ranks_job.py"), str(out)],
                          env=dict(env, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True), "RANKS_OK"),
        (subprocess.Popen(_torchrun(out / "cli_ckpt"), env=dict(env, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True), "done:"),
    ]
    for proc, ok in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0 and ok in stdout, stderr[-3000:]
    (out / "torchrun.out").write_text(stdout)
    return out


@pytest.fixture(scope="module")
def ranks_json(runs):
    return json.loads((runs / "ranks.json").read_text())


class _State:
    """An AdamW state of numpy leaves, as ``assert_state_close`` reads it."""

    def __init__(self, arrays: dict, prefix: str):
        self.step = torch.from_numpy(np.asarray(arrays[prefix + "step"]))
        self.master, self.mu, self.nu = (nest(arrays, f"{prefix}{f}/") for f in ("master", "mu", "nu"))


def _reference(runs, arch):
    arrays = dict(np.load(runs / "reference.npz"))
    states = [type("S", (), {"mu": nest(arrays, f"{arch}/mu{i}/")})() for i in range(STEPS)]
    return arrays[f"{arch}/metrics"], _State(arrays, f"{arch}/o/"), grad_ratios(states)


def _final(runs, arch):
    return dict(np.load(runs / f"final_{arch}.npz"))


def _one_device(runs, arch):
    """The port's three steps on one device: a (2, 2) mesh of CPU positions
    (two MoE groups, as on the ranks); metrics, final state, mu per step."""
    cfg = trained_config(arch)
    params = convert.model_params(nest(dict(np.load(runs / "init.npz")), f"{arch}/"), "cpu")
    opt = adamw.init(params)
    step, _ = make_train_step(cfg, make_mesh((2, 2), ("data", "model"), devices="cpu"),
                              lr_fn=adamw.cosine_schedule(*LR), batch=B, seq_len=L)
    metrics, mus = [], []
    for i in range(STEPS):
        params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, B, L, seed=0, step=i, device="cpu"))
        metrics.append([float(m["loss"]), float(m["grad_norm"]), float(m["lr"])])
        mus.append(type("S", (), {"mu": opt.mu})())
    return np.array(metrics), opt, grad_ratios(mus)


def _assert_metrics_close(got, want, lr_rel=0.0):
    """Per step: the loss within ``REL_LOSS``, the grad norm within ``REL``,
    the lr within ``lr_rel`` (the schedule's float32 arithmetic; XLA may
    fuse it another way)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got[:, 0] - want[:, 0]) <= REL_LOSS * np.abs(want[:, 0])), (got[:, 0], want[:, 0])
    assert rel(got[:, 1], want[:, 1]) < REL, (got[:, 1], want[:, 1])
    assert np.all(np.abs(got[:, 2] - want[:, 2]) <= lr_rel * want[:, 2]), (got[:, 2], want[:, 2])


# --- (a) placements ----------------------------------------------------------------


@pytest.mark.parametrize("case", [c[0] for c in placement_cases()])
def test_each_rank_holds_the_reference_partition_specs_block(runs, ranks_json, case):
    """Every rank's shard of every leaf is the block of the whole leaf that
    the reference's ``NamedSharding`` gives its mesh position: the ``_guard``
    fallbacks replicate, and a dimension over two axes splits major to minor."""
    maps = json.loads((runs / "reference_maps.json").read_text())
    got = ranks_json["placements"][case]
    assert got and all(f"{case}/{k}" in maps for k in got)
    for k, blocks in got.items():
        assert blocks == maps[f"{case}/{k}"], k


def test_placement_cases_cover_every_config_and_two_name_dims():
    cases = placement_cases()
    assert {c[1] for c in cases} == set(ARCH_IDS)
    assert {c[3] for c in cases} == {("data", "model"), ("pod", "data", "model")}
    assert {c[4] for c in cases} == {"2d", "fsdp"}


# --- (b) training ------------------------------------------------------------------


@pytest.mark.parametrize("arch", TRAINED)
def test_ranks_train_as_the_reference_mesh_does(runs, ranks_json, arch):
    got = ranks_json["trained"][arch]
    assert got["all_ranks"] == {"ranks_agree": True, "laid_out": True, "restored": True, "compress_whole": True}
    want, rstate, ratios = _reference(runs, arch)
    _assert_metrics_close(got["metrics"], want, lr_rel=1e-6)
    assert_state_close(_State(_final(runs, arch), "o/"), rstate, list(want[:, 2]), ratios)


@pytest.mark.parametrize("arch", RANK_TRAINED)
def test_ranks_train_as_one_device_does(runs, ranks_json, arch):
    """Also grok with 3 experts, which do not split over the model axis
    (each rank multiplies its slice of F), and mamba2 (each rank's mixer on
    its rows with the whole parameters, their gradients summed over the
    ranks)."""
    assert ranks_json["trained"][arch]["all_ranks"] == {
        "ranks_agree": True, "laid_out": True, "restored": True, "compress_whole": True}
    want, opt, ratios = _one_device(runs, arch)
    _assert_metrics_close(ranks_json["trained"][arch]["metrics"], want)
    assert_state_close(_State(_final(runs, arch), "o/"), opt, list(want[:, 2]), ratios)
    # the norm over DTensor shards is the whole tree's
    norm, norm_whole = ranks_json["trained"][arch]["norm"]
    assert abs(norm - norm_whole) <= 1e-6 * norm_whole


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
def test_ranks_prefill_and_decode_as_one_device_does(ranks_json, arch):
    """Prefill and four decode steps on the (2, 2) mesh of ranks (the K/V
    cache sharded over the sequence, SSM states over heads), against the
    same on whole tensors: float32, only the order of sums differs (1e-5 of
    the logits' largest); a decode from a used cache raises on every rank."""
    for rank in ranks_json["served"][arch]:
        assert len(rank["errs"]) == 5 and max(rank["errs"]) <= 1e-5, rank["errs"]
        assert rank["stale_refused"]


def test_runner_on_ranks_survives_a_fault(ranks_json):
    """``run_training`` on the (2, 2) mesh of ranks: a fault at step 3 on
    every rank restores the step-2 checkpoint (written by rank 0, laid out
    again on every rank) and replays the same batches; the final state
    equals a run without the fault bit for bit, on every rank."""
    for rank in ranks_json["runner"]:
        assert rank["restarts"] == 1 and rank["steps_done"] == 5 and rank["same"], rank
        faulted, clean = rank["losses"]
        assert faulted[:3] + faulted[-1:] == clean[:3] + clean[-1:] and faulted[2] == faulted[3]


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_rank_step_options_as_one_device(runs, name):
    """``make_train_step``'s options on ranks, reduced granite against the
    same on one device. Microbatches (two steps): each cut from the whole
    batch and laid out by the specs of its own size; the tolerances of
    ``test_torch_train_parity.py``. Gradient compression (one step): each
    leaf's int8 scale is the whole gradient's (its max reduced over the
    shards), so an element the two runs round apart moves by one int8 step:
    the first moments within 1/127 of their leaf's largest (``(1 - b1)``
    times the clipped gradient, whose largest element is 127 steps), the
    master within 2 x the lr (the ill-conditioned bound), the loss within
    ``REL_LOSS``."""
    got = dict(np.load(runs / f"variant_{name}.npz"))
    cfg = trained_config("granite-3-8b")
    params = convert.model_params(nest(dict(np.load(runs / "init.npz")), "granite-3-8b/"), "cpu")
    opt = adamw.init(params)
    options, steps = VARIANTS[name]
    step, _ = make_train_step(cfg, make_mesh((2, 2), ("data", "model"), devices="cpu"),
                              lr_fn=adamw.cosine_schedule(*LR), batch=B, seq_len=L, **options)
    losses, lrs, mus = [], [], []
    for i in range(steps):
        params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, B, L, seed=0, step=i, device="cpu"))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
        mus.append(type("S", (), {"mu": opt.mu})())
    assert np.all(np.abs(got["losses"] - losses) <= REL_LOSS * np.abs(losses)), (got["losses"], losses)
    if name == "microbatches":
        assert_state_close(_State(got, ""), opt, lrs, grad_ratios(mus))
        return
    for a, b in zip(jax.tree.leaves(nest(got, "mu/")), jax.tree.leaves(np_tree(opt.mu))):
        assert np.max(np.abs(a - b)) <= np.max(np.abs(b)) / 127 * 1.001
    for a, b in zip(jax.tree.leaves(nest(got, "master/")), jax.tree.leaves(np_tree(opt.master))):
        assert np.max(np.abs(a.astype(np.float64) - b)) <= 2 * sum(lrs)


# --- (c) checkpoints ---------------------------------------------------------------


@pytest.mark.parametrize("arch", TRAINED)
def test_rank_checkpoint_restores_bit_for_bit_in_both_packages(runs, arch):
    root = runs / f"ckpt_{arch}"
    assert sorted(p.name for p in root.iterdir()) == [f"step_{STEPS:08d}"]
    final = _final(runs, arch)
    params = nest(final, "p/")
    like = {"params": params, "opt": adamw.AdamWState(final["o/step"], *(nest(final, f"o/{f}/") for f in ("master", "mu", "nu")))}
    port = checkpoint.restore(str(root), STEPS, like, device="cpu")
    ref = rrestore(str(root), STEPS, like)
    want = jax.tree.leaves(like)
    for got in (jax.tree.leaves(port), jax.tree.leaves(ref)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == np.asarray(b).tobytes()


# --- (d) the CLI under torchrun ----------------------------------------------------


def test_torchrun_two_ranks_train_the_cli(runs):
    """The fixture's ``torchrun --nproc-per-node 2 -m repro_torch.launch.train
    --device cpu``: rank 0 alone reports, six steps on the two ranks' mesh,
    the loss falls, and rank 0 wrote both checkpoints."""
    done = [line for line in (runs / "torchrun.out").read_text().splitlines() if line.startswith("done:")]
    assert len(done) == 1 and "done: 6 steps" in done[0] and "2 ranks" in done[0], done
    first, last = (float(done[0].split(f"{w} loss ")[1].split(",")[0]) for w in ("first", "last"))
    assert last < first, done[0]
    assert sorted(p.name for p in (runs / "cli_ckpt").iterdir()) == ["step_00000003", "step_00000006"]
