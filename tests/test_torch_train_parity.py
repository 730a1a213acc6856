"""repro_torch's train step against repro's, dense attention configs.

Two train steps (B 2, L 16, float32) of each reduced config, from the
reference's initial parameters carried through ``convert.model_params``
and ``convert.opt_state``, on the reference's batches. The MoE, SSM and
hybrid configs are in ``test_torch_train_parity_mixed.py`` (each file runs
on one worker; the reference's compile of a step takes 5-15 s).

The helpers below (one reduced config's train steps in both packages
from the reference's initial state) serve the other training test files.

Tolerances, as the max abs difference over the reference's max abs value
of each leaf: the loss within 1e-5 (one averaged float32 scalar); the
moments ``mu`` and ``nu`` within 1e-4 (linear and quadratic in the
gradient, which the two packages compute in different orders); ``step``
exact (int32). The master weights (and the params cast from them) within
1e-4 too, on every element whose gradient is zero or at least 1% of its
leaf's largest at each step. AdamW's step is ``m / sqrt(v)``: scale-free,
so an element whose gradient is a small fraction of its leaf's carries
the two packages' rounding of that gradient (about 3e-5 of the leaf's
largest, measured) into its step almost undiminished, and a bias that
starts at 0 is made of nothing but such steps. Those elements must differ
by less than ``2 * sum(lr)``: the two packages' steps may point opposite
ways, never further. Measured over the ten reduced configs: every element
beyond 1e-4 had a gradient below 0.23% of its leaf's largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.configs import reduce_for_smoke as rreduce
from repro.data import pipeline as rpipeline
from repro.launch.mesh import make_mesh as rmesh
from repro.launch.mesh import set_mesh
from repro.models import model as rmodel
from repro.optim import adamw as radamw
from repro.train.steps import make_train_step as rmake_train_step
from repro_torch import convert
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

REL_LOSS = 1e-5
REL = 1e-4
CONDITIONED = 1e-2  # a gradient at least this fraction of its leaf's largest
B1 = 0.9  # adamw.update's default


@pytest.fixture(autouse=True)
def one_thread():
    """The port's steps on one CPU thread: the reduced models' ops are tiny,
    and with several test workers on the machine a thread pool per op only
    contends (measured: 0.8 s alone, 45 s beside three busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def np_tree(tree):
    """A tree of tensors or jax arrays as numpy leaves (``jax.tree`` order)."""
    return jax.tree.map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def reference_start(arch: str, seed: int = 0, bf16: bool = False):
    """(reference cfg, port cfg, reference params, reference AdamW state);
    with ``bf16``, params and activations in bf16 (the float32 master)."""
    rcfg, pcfg = rreduce(rget(arch)), reduce_for_smoke(get_config(arch))
    if bf16:
        rcfg = dataclasses.replace(rcfg, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
        pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    params = rmodel.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, pcfg, params, radamw.init(params)


def port_start(params, opt):
    """The reference's params and state carried into the port on the CPU."""
    return convert.model_params(np_tree(params), "cpu"), convert.opt_state(np_tree(opt), "cpu")


def assert_state_close(pstate, rstate, lrs, grad_ratios) -> None:
    """The port's AdamW state against the reference's (module docstring)."""
    assert pstate.step.dtype == torch.int32 and int(pstate.step) == int(np.asarray(rstate.step))
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(np_tree(getattr(pstate, name))), jax.tree.leaves(np_tree(getattr(rstate, name)))):
            assert rel(a, b) < REL, (name, rel(a, b))
    bound = 2 * sum(lrs)
    for a, b, ratio in zip(jax.tree.leaves(np_tree(pstate.master)), jax.tree.leaves(np_tree(rstate.master)), grad_ratios):
        diff = np.abs(a.astype(np.float64) - b)
        fine = (ratio >= CONDITIONED) | (ratio == 0)
        assert np.max(diff[fine], initial=0.0) <= REL * np.max(np.abs(b)), "master"
        assert np.max(diff, initial=0.0) <= bound, "master, an ill-conditioned element"


def grad_ratios(states) -> list:
    """Per leaf, the smallest over the steps of |g| / max |g| of the leaf,
    recovered from the reference's first moments (``mu_t = b1 mu_{t-1} +
    (1 - b1) s_t g_t``; the clip scale ``s_t`` cancels in the ratio)."""
    out, prev = None, None
    for st in states:
        mu = [np.asarray(m, np.float64) for m in jax.tree.leaves(np_tree(st.mu))]
        g = mu if prev is None else [m - B1 * p for m, p in zip(mu, prev)]
        r = [np.abs(x) / max(np.max(np.abs(x)), 1e-300) for x in g]
        out = r if out is None else [np.minimum(a, b) for a, b in zip(out, r)]
        prev = mu
    return out


def two_steps(arch: str, batch: int, seq_len: int, steps: int = 2) -> None:
    """``steps`` train steps of a reduced config in both packages from the
    reference's initial state, on the reference's batches: losses, state
    and params held to each other (module docstring)."""
    rcfg, pcfg, params, opt = reference_start(arch)
    pp, po = port_start(params, opt)
    rlr, plr = radamw.cosine_schedule(1e-3, 1, 4), adamw.cosine_schedule(1e-3, 1, 4)
    mesh = rmesh((1, 1), ("data", "model"))
    rstates, rlosses, lrs = [], [], []
    with set_mesh(mesh):
        rstep, _ = rmake_train_step(rcfg, mesh, lr_fn=rlr, batch=batch, seq_len=seq_len)
        for s in range(steps):
            params, opt, m = rstep(params, opt, rpipeline.synthetic_batch(rcfg, batch, seq_len, seed=0, step=s))
            rstates.append(opt)
            rlosses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
    pstep, _ = make_train_step(
        pcfg, make_mesh((1, 1), ("data", "model"), devices="cpu"), lr_fn=plr, batch=batch, seq_len=seq_len
    )
    for s in range(steps):
        pp, po, m = pstep(pp, po, pipeline.synthetic_batch(pcfg, batch, seq_len, seed=0, step=s, device="cpu"))
        assert m["loss"].dtype == torch.float32
        assert abs(float(m["loss"]) - rlosses[s]) <= REL_LOSS * abs(rlosses[s]), (s, float(m["loss"]), rlosses[s])
    ratios = grad_ratios(rstates)
    assert_state_close(po, opt, lrs, ratios)
    bound = 2 * sum(lrs)
    for a, b, ratio in zip(jax.tree.leaves(np_tree(pp)), jax.tree.leaves(np_tree(params)), ratios):
        assert a.dtype == b.dtype == np.float32
        diff = np.abs(a.astype(np.float64) - b)
        fine = (ratio >= CONDITIONED) | (ratio == 0)
        assert np.max(diff[fine], initial=0.0) <= REL * np.max(np.abs(b))
        assert np.max(diff, initial=0.0) <= bound


ARCHS = ["qwen2-1.5b", "gemma3-12b", "granite-3-8b", "command-r-35b", "internvl2-1b", "musicgen-large"]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch):
    two_steps(arch, batch=2, seq_len=16)


# The mixed-precision step (bf16 params, activations and gradients; float32
# master and moments) against the reference's. The two packages' bf16 ops
# round differently, so the gradients differ by a few percent of a leaf's
# largest (measured on reduced qwen2, B 2, L 16, two steps: loss 4.0e-5,
# grad norm 1.5e-4, mu 2.5e-2, nu 3.6e-2); the limits are about twice
# that. The grad norm's limit catches a norm taken over the bf16 gradients
# before their upcast (measured 7.7e-4 at the second step).
BF16_LOSS, BF16_NORM, BF16_MU, BF16_NU = 1e-4, 3e-4, 5e-2, 7e-2


def test_bf16_train_steps_match_reference():
    rcfg, pcfg, params, opt = reference_start("qwen2-1.5b", bf16=True)
    pp, po = port_start(params, opt)
    assert pp["embed"].dtype == torch.bfloat16 and po.master["embed"].dtype == torch.float32
    rlr, plr = radamw.cosine_schedule(1e-3, 1, 4), adamw.cosine_schedule(1e-3, 1, 4)
    mesh = rmesh((1, 1), ("data", "model"))
    ref, lrs = [], []
    with set_mesh(mesh):
        rstep, _ = rmake_train_step(rcfg, mesh, lr_fn=rlr, batch=2, seq_len=16)
        for s in range(2):
            params, opt, m = rstep(params, opt, rpipeline.synthetic_batch(rcfg, 2, 16, seed=0, step=s))
            ref.append((float(m["loss"]), float(m["grad_norm"]), np_tree(opt)))  # donated next step
            lrs.append(float(m["lr"]))
    pstep, _ = make_train_step(pcfg, make_mesh((1, 1), ("data", "model"), devices="cpu"), lr_fn=plr, batch=2, seq_len=16)
    for s in range(2):
        pp, po, m = pstep(pp, po, pipeline.synthetic_batch(pcfg, 2, 16, seed=0, step=s, device="cpu"))
        loss, norm, ropt = ref[s]
        assert m["loss"].dtype == torch.float32 and abs(float(m["loss"]) - loss) <= BF16_LOSS * abs(loss), s
        assert abs(float(m["grad_norm"]) - norm) <= BF16_NORM * norm, (s, float(m["grad_norm"]), norm)
        assert po.step.dtype == torch.int32 and int(po.step) == s + 1
        for name, limit in (("mu", BF16_MU), ("nu", BF16_NU)):
            for a, b in zip(jax.tree.leaves(np_tree(getattr(po, name))), jax.tree.leaves(np_tree(getattr(ropt, name)))):
                assert rel(a, b) < limit, (s, name, rel(a, b))
        for a, b in zip(jax.tree.leaves(np_tree(po.master)), jax.tree.leaves(np_tree(ropt.master))):
            assert np.max(np.abs(a.astype(np.float64) - b), initial=0.0) <= 2 * sum(lrs[: s + 1]), "master"
        for p, w in zip(jax.tree.leaves(pp), jax.tree.leaves(po.master)):  # the params: the master cast to bf16
            assert p.dtype == torch.bfloat16 and torch.equal(p, w.to(torch.bfloat16))

