"""repro_torch.optim against repro.optim on the same numpy inputs.

The optimizer cases of ``tests/test_system.py`` run under their names on
the port; then ``adamw.update`` (bf16 and float32 params, a ``None`` grad
where the reference gets zeros), ``global_norm``, ``cosine_schedule``,
``init`` and the int8 compression with error feedback are held to the
reference's leaf for leaf.

Tolerances: float32 elementwise arithmetic in the same order in both
packages; only the sums (the global norm, XLA's reduction tree against
PyTorch's) round differently, so 1e-6 relative (max abs difference over
the reference's max abs value). The int8 codes, the step (int32) and the
dtypes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro_torch import convert
from repro_torch.optim import adamw, compress

REL = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def _tree(rng):
    """A parameter-shaped tree: nested dicts, leaves of several shapes."""
    return {
        "embed": rng.standard_normal((16, 8)).astype(np.float32),
        "final_norm": rng.standard_normal(8).astype(np.float32) * 0.1,
        "layers": {
            "wq": rng.standard_normal((2, 8, 8)).astype(np.float32) * 0.3,
            "bq": rng.standard_normal((2, 8)).astype(np.float32) * 0.01,
            "unused": rng.standard_normal((2, 4)).astype(np.float32),
        },
    }


def _grads(rng, tree, scale):
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), tree)


# --- tests/test_system.py, on the port ---------------------------------------


def test_adamw_step_and_clip():
    params = {"w": torch.ones((4, 4))}
    st = adamw.init(params)
    grads = {"w": torch.full((4, 4), 100.0)}  # should be clipped
    new_params, st2, m = adamw.update(
        grads, st, lr_fn=lambda s: torch.tensor(0.1), clip_norm=1.0, param_dtype=torch.float32
    )
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    assert int(st2.step) == 1
    assert not np.allclose(new_params["w"].numpy(), 1.0)


def test_grad_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)) * 1e-3)}
    ef = compress.init_ef(g)
    deq, ef2 = compress.ef_compress_grads(g, ef)
    # int8 quantization error is bounded by scale/2 per element
    scale = float(torch.max(torch.abs(g["w"]))) / 127.0
    assert float(torch.max(torch.abs(deq["w"] - g["w"]))) <= scale * 0.51
    # residual carries the error; applying twice recovers ~all mass
    deq2, _ = compress.ef_compress_grads({"w": torch.zeros_like(g["w"])}, ef2)
    total = (deq["w"] + deq2["w"]).numpy()
    np.testing.assert_allclose(total, g["w"].numpy(), atol=scale)


# --- parity with repro.optim --------------------------------------------------


def test_init_matches_reference():
    tree = _tree(np.random.default_rng(0))
    ref = jax.tree.map(np.asarray, radamw.init(jax.tree.map(jnp.asarray, tree)))
    port = adamw.init(convert.model_params(tree, "cpu", torch.bfloat16))
    assert port.step.dtype == torch.int32 and port.step.shape == () and int(port.step) == 0
    for name in ("master", "mu", "nu"):
        want = jax.tree.leaves(getattr(ref, name))
        got = jax.tree.leaves(jax.tree.map(_np, getattr(port, name)))
        for a, b in zip(got, want):
            assert a.dtype == np.float32 and a.shape == b.shape
    # the master is the bf16 params widened, not the float32 draws
    master = port.master["layers"]["wq"]
    assert torch.equal(master, master.bfloat16().float())


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_reference(param_dtype, steps):
    """``steps`` updates from one state, the grads drawn per step (their
    norm above the clip on odd steps, below it on even ones); the leaf the
    loss never reads has a ``None`` grad in the port and zeros in the
    reference."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    rstate = radamw.init(jax.tree.map(jnp.asarray, tree))
    pstate = convert.opt_state(jax.tree.map(np.asarray, rstate), "cpu")
    rdt, pdt = (jnp.bfloat16, torch.bfloat16) if param_dtype == "bfloat16" else (jnp.float32, torch.float32)
    rlr, plr = radamw.cosine_schedule(1e-2, 2, 10), adamw.cosine_schedule(1e-2, 2, 10)
    for s in range(steps):
        g = _grads(rng, tree, 1.0 if s % 2 == 0 else 1e-3)
        g["layers"]["unused"] = np.zeros_like(g["layers"]["unused"])
        rp, rstate, rm = radamw.update(jax.tree.map(jnp.asarray, g), rstate, lr_fn=rlr, param_dtype=rdt)
        pg = convert.model_params(g, "cpu")
        pg["layers"]["unused"] = None
        pp, pstate, pm = adamw.update(pg, pstate, lr_fn=plr, param_dtype=pdt)
        assert pstate.step.dtype == torch.int32 and int(pstate.step) == int(rstate.step) == s + 1
        assert _rel(pm["grad_norm"].numpy(), rm["grad_norm"]) < REL
        assert _rel(pm["lr"].numpy(), rm["lr"]) < REL
    for name in ("master", "mu", "nu"):
        for a, b in zip(jax.tree.leaves(jax.tree.map(_np, getattr(pstate, name))), jax.tree.leaves(getattr(rstate, name))):
            assert _rel(a, np.asarray(b)) < REL, name
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t, pp)), jax.tree.leaves(rp)):
        assert a.dtype == pdt
        assert _rel(_np(a), np.asarray(b.astype(jnp.float32))) < REL
    # the unread leaf still decays
    assert not np.array_equal(_np(pstate.master["layers"]["unused"]), tree["layers"]["unused"])


def test_float32_params_do_not_share_storage_with_the_master():
    params = {"w": torch.ones((3, 3)), "b": torch.zeros(3)}
    st = adamw.init(params)
    grads = {"w": torch.full((3, 3), 0.5), "b": torch.ones(3)}
    new, st2, _ = adamw.update(grads, st, lr_fn=lambda s: torch.tensor(0.1), param_dtype=torch.float32)
    for k in params:
        assert new[k].dtype == torch.float32
        assert new[k].untyped_storage().data_ptr() != st2.master[k].untyped_storage().data_ptr()
        before = st2.master[k].clone()
        new[k].add_(1.0)  # an in-place write to the params leaves the master alone
        assert torch.equal(st2.master[k], before)
    # and init copies: the params given to it are not the master either
    assert params["w"].untyped_storage().data_ptr() != st.master["w"].untyped_storage().data_ptr()


def test_global_norm_and_schedule_match_reference():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    want = radamw.global_norm(jax.tree.map(jnp.asarray, tree))
    got = adamw.global_norm(convert.model_params(tree, "cpu"))
    assert got.dtype == torch.float32 and _rel(got.numpy(), want) < REL
    rlr, plr = radamw.cosine_schedule(3e-4, 10, 100), adamw.cosine_schedule(3e-4, 10, 100)
    steps = np.arange(0, 130, dtype=np.int32)
    got = np.array([float(plr(torch.tensor(s, dtype=torch.int32))) for s in steps], np.float32)
    want = np.array([float(rlr(jnp.int32(s))) for s in steps], np.float32)
    assert _rel(got, want) < REL


def test_compress_matches_reference():
    rng = np.random.default_rng(3)
    for g in (
        rng.standard_normal((33, 7)).astype(np.float32) * 1e-3,
        np.array([0.5, -0.5, 1.5, 2.5, -127.0, 127.0], np.float32),  # exact halves: round half to even
        np.zeros(5, np.float32),  # the scale's floor
    ):
        rq, rs = rcompress.compress(jnp.asarray(g))
        pq, ps = compress.compress(torch.from_numpy(g))
        assert pq.dtype == torch.int8 and np.array_equal(pq.numpy(), np.asarray(rq))
        assert _rel(ps.numpy(), rs) < REL
        assert _rel(compress.decompress(pq, ps).numpy(), rcompress.decompress(rq, rs)) < REL
    grads = {"a": rng.standard_normal((8, 8)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    rdeq, ref_ef = rcompress.ef_compress_grads(jax.tree.map(jnp.asarray, grads), rcompress.init_ef(grads))
    pdeq, port_ef = compress.ef_compress_grads(
        convert.model_params(grads, "cpu"), compress.init_ef(convert.model_params(grads, "cpu"))
    )
    for _ in range(2):  # twice: the carried residuals feed the second round
        for a, b in zip(jax.tree.leaves(jax.tree.map(_np, pdeq)), jax.tree.leaves(rdeq)):
            assert _rel(a, np.asarray(b)) < REL
        for a, b in zip(jax.tree.leaves(jax.tree.map(_np, port_ef.residual)), jax.tree.leaves(ref_ef.residual)):
            assert np.max(np.abs(a - np.asarray(b))) <= REL * np.max(np.abs(grads["a"]))
        rdeq, ref_ef = rcompress.ef_compress_grads(jax.tree.map(jnp.asarray, grads), ref_ef)
        pdeq, port_ef = compress.ef_compress_grads(convert.model_params(grads, "cpu"), port_ef)
