"""repro_torch.train: the step builders and the runner, against repro.train.

The training cases of ``tests/test_system.py`` run under their names on the
port. Then, against the reference on the same numpy inputs (the reference's
initial state carried through ``convert``): microbatch accumulation,
``moe_ffn`` with two groups, and a reduced MoE config whose mesh gives two
groups (the reference run in-process on its one device, the mesh's sizes
given through the config); and the reference's sharded-train child of
``tests/test_distributed.py`` (granite on a ``(2, 4)`` mesh of 8 fake XLA
devices) against the port on 8 CPU positions. On the port alone: remat on
and off give bit-identical losses and gradients, the step builders refuse a
mesh over several devices, ``place_state`` checks the trees, and the
prefill and serve steps equal ``model.prefill`` and ``model.decode_step``.

Tolerances: as ``test_torch_train_parity.py`` sets out (loss 1e-5, state
1e-4, max abs difference over the reference's max abs value); ``moe_ffn``
1e-5 (one module, float32), its routing exact; remat exact.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as rpipeline
from repro.launch.mesh import make_mesh as rmesh
from repro.launch.mesh import set_mesh as rset_mesh
from repro.models import model as rmodel
from repro.models import moe as rmoe
from repro.optim import adamw as radamw
from repro.train.steps import make_train_step as rmake_train_step
from repro_torch import checkpoint, convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_mesh, set_mesh
from repro_torch.models import model, moe, transformer
from repro_torch.optim import adamw
from repro_torch.train import runner as runner_lib
from repro_torch.train import steps as steps_lib
from repro_torch.train.steps import make_train_step, place_state
from test_torch_train_parity import REL, REL_LOSS, np_tree, one_thread, port_start, reference_start, rel  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
B, L = 4, 16  # one shape for the reference's compiles in this file


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _mesh(shape=(1, 1)):
    return make_mesh(shape, ("data", "model"), devices="cpu")


def _setup(arch="qwen2-1.5b", steps=12):
    cfg = reduce_for_smoke(get_config(arch))
    mesh = _mesh()
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    opt = adamw.init(params)
    step_fn, _ = make_train_step(cfg, mesh, lr_fn=adamw.cosine_schedule(1e-3, 2, steps), batch=4, seq_len=32)
    return cfg, mesh, params, opt, step_fn


# --- tests/test_system.py, on the port ---------------------------------------


def test_training_reduces_loss():
    cfg, mesh, params, opt, step_fn = _setup(steps=30)
    with set_mesh(mesh):
        losses = []
        for s in range(30):
            batch = pipeline.synthetic_batch(cfg, 4, 32, seed=7, step=0, device="cpu")  # same batch
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[:3] + losses[-3:]


def test_runner_fault_recovery(tmp_path):
    """Kill the step twice; the runner must restart from checkpoints and
    finish all steps with deterministic data replay."""
    cfg, mesh, params, opt, step_fn = _setup()
    boom = {8: True, 5: True}

    def fault_hook(step):
        if boom.pop(step, None):
            raise RuntimeError(f"injected node failure at step {step}")

    rcfg = runner_lib.RunnerConfig(total_steps=12, ckpt_dir=str(tmp_path), ckpt_every=4, seed=3, max_retries=5)
    with set_mesh(mesh):
        report = runner_lib.run_training(step_fn, params, opt, cfg, 4, 32, rcfg, fault_hook=fault_hook, device="cpu")
    assert report.restarts == 2
    assert report.steps_done >= 12
    assert checkpoint.latest_step(str(tmp_path)) == 12
    # the replayed steps saw the same batches: the final state equals an
    # uninterrupted run's, bit for bit
    clean = runner_lib.run_training(
        step_fn, params, opt, cfg, 4, 32,
        runner_lib.RunnerConfig(total_steps=12, ckpt_dir=str(tmp_path / "clean"), ckpt_every=4, seed=3),
        device="cpu",
    )
    for a, b in zip(jax.tree.leaves(np_tree(report.opt_state)), jax.tree.leaves(np_tree(clean.opt_state))):
        assert np.array_equal(a, b)


def test_runner_gives_up_after_its_retry_budget(tmp_path):
    cfg, mesh, params, opt, step_fn = _setup()

    def always(step):  # a fault before the first checkpoint, on every attempt
        raise RuntimeError("persistent fault")

    rcfg = runner_lib.RunnerConfig(total_steps=6, ckpt_dir=str(tmp_path), ckpt_every=2, max_retries=2)
    with pytest.raises(RuntimeError, match="persistent fault"):
        runner_lib.run_training(step_fn, params, opt, cfg, 4, 32, rcfg, fault_hook=always, device="cpu")


def test_microbatch_accumulation_matches_single():
    cfg = reduce_for_smoke(get_config("granite-3-8b"))
    mesh = _mesh()
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    batch = pipeline.synthetic_batch(cfg, 4, 32, seed=0, step=0, device="cpu")
    with set_mesh(mesh):
        zero = lambda s: torch.tensor(0.0)
        s1, _ = make_train_step(cfg, mesh, lr_fn=zero, batch=4, seq_len=32)
        s2, _ = make_train_step(cfg, mesh, lr_fn=zero, batch=4, seq_len=32, microbatches=2)
        p1, _, m1 = s1(params, adamw.init(params), batch)
        p2, _, m2 = s2(params, adamw.init(params), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)


# --- against the reference ------------------------------------------------------


def test_microbatches_match_reference():
    """microbatches=2 in both packages: the loss sum and the float32
    gradient sums divided by 2, then one AdamW step."""
    rcfg, pcfg, params, opt = reference_start("granite-3-8b")
    pp, po = port_start(params, opt)
    mesh = rmesh((1, 1), ("data", "model"))
    with rset_mesh(mesh):
        rstep, _ = rmake_train_step(
            rcfg, mesh, lr_fn=radamw.cosine_schedule(1e-3, 1, 4), batch=B, seq_len=L, microbatches=2
        )
        _, ropt, rm = rstep(params, opt, rpipeline.synthetic_batch(rcfg, B, L, seed=0, step=0))
    pstep, _ = make_train_step(
        pcfg, _mesh(), lr_fn=adamw.cosine_schedule(1e-3, 1, 4), batch=B, seq_len=L, microbatches=2
    )
    _, popt, pm = pstep(pp, po, pipeline.synthetic_batch(pcfg, B, L, seed=0, step=0, device="cpu"))
    assert abs(float(pm["loss"]) - float(rm["loss"])) <= REL_LOSS * abs(float(rm["loss"]))
    assert rel(pm["grad_norm"].numpy(), rm["grad_norm"]) < REL
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(np_tree(getattr(popt, name))), jax.tree.leaves(np_tree(getattr(ropt, name)))):
            assert rel(a, b) < REL, name


def test_moe_ffn_with_two_groups_matches_reference():
    rng = np.random.default_rng(5)
    t, d, e, f, k = 24, 16, 4, 32, 2
    x = rng.standard_normal((t, d)).astype(np.float32)
    ws = [
        rng.standard_normal((d, e)).astype(np.float32),
        *(rng.standard_normal(s).astype(np.float32) * 0.2 for s in ((e, d, f), (e, d, f), (e, f, d))),
    ]
    ffn = jax.jit(rmoe.moe_ffn, static_argnames=("top_k", "capacity_factor", "num_groups"))
    for groups, cf in ((2, 1.0), (2, 8.0), (3, 1.25), (5, 1.0)):  # 5 does not divide 24: one group
        ref = ffn(jnp.asarray(x), *map(jnp.asarray, ws), top_k=k, capacity_factor=cf, num_groups=groups)
        port = moe.moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws), top_k=k, capacity_factor=cf, num_groups=groups)
        assert rel(port.y.numpy(), ref.y) < 1e-5
        # the same assignments dropped (the fraction's float mean may round apart)
        assert round(float(port.dropped_frac) * t * k) == round(float(ref.dropped_frac) * t * k)
        assert abs(float(port.aux_loss) - float(ref.aux_loss)) <= 1e-5 * abs(float(ref.aux_loss))
    one = moe.moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws), top_k=k, capacity_factor=1.0, num_groups=1)
    two = moe.moe_ffn(torch.from_numpy(x), *map(torch.from_numpy, ws), top_k=k, capacity_factor=1.0, num_groups=2)
    assert float(one.dropped_frac) != float(two.dropped_frac)  # the groups' capacity routes differently


def test_moe_groups_on_a_mesh_match_reference():
    """Reduced grok, capacity_factor 1.0 (tokens are dropped, so the groups
    change the routing), on a (2, 1) mesh in the port: make_train_step
    writes the mesh's axes into the config and each layer routes two groups.
    The reference runs the same config, its mesh sizes given directly, on
    its one device under a (1, 1) mesh."""
    rcfg, pcfg, params, opt = reference_start("grok-1-314b")
    sizes = dict(mesh_dp=("data",), mesh_model="model", mesh_model_size=1, mesh_axis_sizes=(("data", 2), ("model", 1)))
    rcfg = dataclasses.replace(rcfg, capacity_factor=1.0, **sizes)
    pcfg = dataclasses.replace(pcfg, capacity_factor=1.0)
    pp, po = port_start(params, opt)
    rlr = radamw.cosine_schedule(1e-3, 1, 4)
    with rset_mesh(rmesh((1, 1), ("data", "model"))):
        vg = jax.jit(jax.value_and_grad(rmodel.train_loss), static_argnums=2)
        rl, rg = vg(params, rpipeline.synthetic_batch(rcfg, B, L, seed=0, step=0), rcfg)
        _, ropt, _ = radamw.update(rg, opt, lr_fn=rlr, param_dtype=jnp.float32)
    mesh = _mesh((2, 1))
    pstep, _ = make_train_step(pcfg, mesh, lr_fn=adamw.cosine_schedule(1e-3, 1, 4), batch=B, seq_len=L)
    assert transformer.moe_groups(steps_lib._with_mesh_axes(pcfg, mesh, B), B * L) == 2
    batch = pipeline.synthetic_batch(pcfg, B, L, seed=0, step=0, device="cpu")
    _, popt, pm = pstep(pp, po, batch)
    assert abs(float(pm["loss"]) - float(rl)) <= REL_LOSS * abs(float(rl))
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(np_tree(getattr(popt, name))), jax.tree.leaves(np_tree(getattr(ropt, name)))):
            assert rel(a, b) < REL, name
    ungrouped, _ = make_train_step(pcfg, _mesh(), lr_fn=adamw.cosine_schedule(1e-3, 1, 4), batch=B, seq_len=L)
    assert float(ungrouped(*port_start(params, opt), batch)[2]["loss"]) != float(pm["loss"])


_CHILD_TRAIN = textwrap.dedent(
    """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config, reduce_for_smoke
    from repro.data import pipeline
    from repro.launch.mesh import make_mesh, set_mesh
    from repro.models import model
    from repro.optim import adamw
    from repro.train.steps import make_train_step, place_state

    def flat(prefix, tree):  # {"p/layers/wq": array, "o/master/embed": ...}
        paths = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {prefix + "/".join(str(getattr(k, "key", getattr(k, "name", ""))) for k in path): np.asarray(v)
                for path, v in paths}

    cfg = reduce_for_smoke(get_config("granite-3-8b"))
    mesh = make_mesh((2, 4), ("data", "model"))
    with set_mesh(mesh):
        params = model.init_params(cfg, jax.random.PRNGKey(0))
        opt = adamw.init(params)
        init = {**flat("p/", params), **flat("o/", opt)}
        step, info = make_train_step(cfg, mesh, lr_fn=lambda s: jnp.float32(1e-3),
                                     batch=4, seq_len=64)
        params, opt = place_state(mesh, info, params, opt)
        losses = []
        for i in range(3):
            batch = pipeline.synthetic_batch(cfg, 4, 64, seed=0, step=i)
            params, opt, m = step(params, opt, batch)
            assert np.isfinite(float(m["loss"]))
            losses.append(float(m["loss"]))
    np.savez(sys.argv[1], losses=np.array(losses, np.float64), **init)
    print("SHARDED_TRAIN_OK")
    """
)


@pytest.fixture(scope="module")
def sharded_train_child(tmp_path_factory):
    """The reference's granite run on a (2, 4) mesh of 8 fake devices:
    its initial state and its three losses."""
    out = tmp_path_factory.mktemp("child") / "train.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _CHILD_TRAIN, str(out)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0 and "SHARDED_TRAIN_OK" in res.stdout, res.stderr[-3000:]
    return dict(np.load(out))


def _unflat(arrays: dict, prefix: str) -> dict:
    """The nested dict under ``prefix`` of the child's "a/b/c" keys."""
    out = {}
    for key, v in arrays.items():
        if key.startswith(prefix):
            *parents, leaf = key[len(prefix):].split("/")
            node = out
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return out


def test_sharded_train_on_2x4_matches_reference_child(sharded_train_child):
    """The port on a (2, 4) mesh of 8 CPU positions, from the child's
    initial state: the same three losses."""
    got = sharded_train_child
    cfg = reduce_for_smoke(get_config("granite-3-8b"))
    mesh = _mesh((2, 4))
    assert mesh.size == 8 and mesh.physical_devices == (torch.device("cpu"),)
    params = convert.model_params(_unflat(got, "p/"), "cpu")
    opt = convert.opt_state(
        adamw.AdamWState(got["o/step"], *(_unflat(got, f"o/{f}/") for f in ("master", "mu", "nu"))), "cpu"
    )
    step, info = make_train_step(cfg, mesh, lr_fn=lambda s: torch.tensor(1e-3), batch=4, seq_len=64)
    params, opt = place_state(mesh, info, params, opt)
    losses = []
    for i in range(3):
        params, opt, m = step(params, opt, pipeline.synthetic_batch(cfg, 4, 64, seed=0, step=i, device="cpu"))
        losses.append(float(m["loss"]))
    want = got["losses"]
    assert np.all(np.abs(np.array(losses) - want) <= REL_LOSS * np.abs(want)), (losses, want)


# --- the port alone ---------------------------------------------------------------


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "grok-1-314b", "mamba2-2.7b", "zamba2-2.7b"])
def test_remat_changes_no_number(arch, policy):
    """Remat recomputes the forward in the backward pass: loss and every
    gradient are bit-identical with it and without it."""
    cfg = reduce_for_smoke(get_config(arch))
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    batch = pipeline.synthetic_batch(cfg, 2, 48, seed=1, step=0, device="cpu")
    off = steps_lib.value_and_grad(params, batch, cfg)
    on_cfg = dataclasses.replace(cfg, remat=True, remat_policy=policy)
    with mock.patch("torch.utils.checkpoint.checkpoint", wraps=torch.utils.checkpoint.checkpoint) as spy:
        on = steps_lib.value_and_grad(params, batch, on_cfg)
    assert spy.call_count > 0
    assert torch.equal(on[0], off[0])
    for a, b in zip(jax.tree.leaves(np_tree(on[1])), jax.tree.leaves(np_tree(off[1]))):
        assert np.array_equal(a, b)


def test_train_step_leaves_its_inputs_as_they_were():
    """The step is functional (it donates nothing, unlike the reference's
    bf16 step): the params and state it was given keep their values, and
    the new ones share no storage with them."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2-1.5b")), dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    opt = adamw.init(params)
    step_fn, _ = make_train_step(cfg, _mesh(), lr_fn=lambda s: torch.tensor(1e-3), batch=2, seq_len=16)
    before = [t.clone() for t in jax.tree.leaves((params, opt))]
    new = step_fn(params, opt, pipeline.synthetic_batch(cfg, 2, 16, seed=0, step=0, device="cpu"))[:2]
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves((params, opt)), before))
    old = {t.untyped_storage().data_ptr() for t in jax.tree.leaves((params, opt))}
    assert not old & {t.untyped_storage().data_ptr() for t in jax.tree.leaves(new)}


def test_steps_refuse_a_mesh_over_several_devices():
    cfg = reduce_for_smoke(get_config("qwen2-1.5b"))
    two = make_mesh((2,), ("data",), devices=["cpu", "meta"])
    for build in (
        lambda: make_train_step(cfg, two, lr_fn=lambda s: torch.tensor(1e-3), batch=2, seq_len=8),
        lambda: steps_lib.make_prefill_step(cfg, two, batch=2, seq_len=8),
        lambda: steps_lib.make_serve_step(cfg, two, batch=2, capacity=8),
    ):
        with pytest.raises(NotImplementedError, match="one device"):
            build()


def test_place_state_checks_the_trees():
    cfg = reduce_for_smoke(get_config("qwen2-1.5b"))
    mesh = _mesh((2, 4))
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    opt = adamw.init(params)
    _, info = make_train_step(cfg, mesh, lr_fn=lambda s: torch.tensor(1e-3), batch=2, seq_len=8)
    p2, o2 = place_state(mesh, info, params, opt)
    assert {t.device for t in jax.tree.leaves((p2, o2))} == {torch.device("cpu")}
    assert isinstance(place_state(mesh, info, params), dict)
    missing = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(ValueError):
        place_state(mesh, info, missing)
    extra = {**params, "layers": {**params["layers"], "spare": torch.zeros(1)}}
    with pytest.raises(ValueError):
        place_state(mesh, info, extra, opt)


def test_prefill_and_serve_steps_equal_the_model():
    cfg = dataclasses.replace(reduce_for_smoke(get_config("gemma3-12b")), cache_pad=2)
    mesh = _mesh((2, 4))
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    tokens = pipeline.synthetic_batch(cfg, 2, 12, seed=0, step=0, device="cpu")["tokens"]
    prefill, specs = steps_lib.make_prefill_step(cfg, mesh, batch=2, seq_len=10)
    assert set(specs) == {"params", "input", "cache"}
    logits, cache = prefill(params, tokens[:, :10])
    want, wcache = model.prefill(params, tokens[:, :10], cfg)
    assert torch.equal(logits, want)
    serve, specs = steps_lib.make_serve_step(cfg, mesh, batch=2, capacity=12)
    assert set(specs) == {"params", "token", "cache"}
    got, _ = serve(params, tokens[:, 10:11], cache)
    want, _ = model.decode_step(params, tokens[:, 10:11], wcache, cfg)
    assert torch.equal(got, want)
