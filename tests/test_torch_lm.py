"""repro_torch's LM substrate against repro's, whole models.

For every reduced config the reference's parameters (``repro.models.model.
init_params``, PRNG key 0) are carried into the port through
``convert.model_params``; the same numpy tokens then go through both
packages' ``prefill``, four ``decode_step``s and ``train_loss``, on the CPU.
The full-size configs are compared as shapes only (the port's ``meta``
trees against the reference's ``ShapeDtypeStruct``s), and two of them run
at full width and depth 1.

Tolerances: float32 on the CPU, as the max abs difference over the
reference's max abs value. Both packages compute the same float32
operations in different orders (XLA's fused reductions, PyTorch's BLAS), so
their roundings differ: 1e-4 over a reduced model (2–4 layers, the error
grows with depth), 1e-5 for the loss (one averaged scalar), 1e-4 for the
full-width depth-1 logits (sums over 1536–10240 terms). Integers (cache
lengths, shapes, parameter counts) are exact.

bf16 (the serving dtype), four reduced models: 8e-2 against the
reference's bf16. The attention and norm arithmetic is held to the
reference module by module (test_torch_models.py); over a model, XLA's and
PyTorch's elementwise bf16 ops (``silu``, the SSD's gates) round a
different fraction of their outputs one bf16 step (2^-8) apart, and every
later layer carries those steps. Measured on the CPU: logits 6.9e-3 to
1.95e-2 over all ten reduced configs, cache leaves up to 5.05e-2 (zamba2's
last SSD state), the same size as the reference's own bf16 against its
float32 on the same weights (8e-3 to 3.4e-2). So each output must also
lie within twice the reference's bf16 error of that float32 run (measured:
at most 1.49 times, qwen2). The top-1 token at every step is exact.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import specs as rspecs
from repro.models import model as rmodel
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.launch import specs as pspecs
from repro_torch.models import model as pmodel

ARCHS = pconfigs.ARCH_IDS
B, L, EXTRA = 2, 40, 4  # L: a ragged attention chunk (64) and SSD chunk (32)
REL_MODEL = 1e-4
REL_LOSS = 1e-5
REL_BF16 = 8e-2
BF16_ARCHS = ["qwen2-1.5b", "gemma3-12b", "grok-1-314b", "zamba2-2.7b"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _inputs(cfg, np_params, tokens):
    """Token ids, or (for the embedding-fed frontends) their embedding rows."""
    return np_params["embed"][tokens] if cfg.embeds_input else tokens


def _reduced(configs, arch, dtype):
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)


def _serve(params, np_params, tokens, cfg):
    """The reference's prefill and four decode steps: (prefill logits and
    cache, each step's logits, the final cache), as numpy."""
    logits, cache = rmodel.prefill(params, jnp.asarray(_inputs(cfg, np_params, tokens[:, :L])), cfg)
    prefill_out = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    steps = []
    for t in range(EXTRA):
        lg, cache = rmodel.decode_step(params, jnp.asarray(tokens[:, L + t : L + t + 1]), cache, cfg)
        steps.append(np.asarray(lg))
    return prefill_out, steps, jax.tree.map(np.asarray, cache)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, bf16=False):
    """The reference's reduced model on numpy tokens: prefill, four decode
    steps (each step's logits and the final cache) and the train loss. In
    bf16 (no loss), also the same run in float32 on those bf16 weights
    upcast: the answer both packages' bf16 approximates."""
    cfg = _reduced(rconfigs, arch, jnp.bfloat16 if bf16 else None)
    params = rmodel.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, L + EXTRA)).astype(np.int32)
    prefill_out, steps, cache = _serve(params, np_params, tokens, cfg)
    batch = {"labels": tokens[:, :L]}
    batch["embeds" if cfg.embeds_input else "tokens"] = _inputs(cfg, np_params, tokens[:, :L])
    loss = anchor = None
    if bf16:
        up = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        anchor = _serve(up, jax.tree.map(np.asarray, up), tokens, _reduced(rconfigs, arch, None))
    else:
        loss = float(rmodel.train_loss(params, jax.tree.map(jnp.asarray, batch), cfg))
    return dict(
        np_params=np_params, tokens=tokens, prefill=prefill_out, steps=steps,
        cache=cache, batch=batch, loss=loss, anchor=anchor,
    )


def _port(arch, bf16=False):
    cfg = _reduced(pconfigs, arch, torch.bfloat16 if bf16 else None)
    ref = _reference_run(arch, bf16)
    return cfg, ref, convert.model_params(ref["np_params"], device="cpu")


def _assert_cache_equal(ref_cache, port_cache, rel):
    assert int(port_cache.length) == int(ref_cache.length)
    for f in ("k", "v", "conv", "ssd"):
        r, p = getattr(ref_cache, f), getattr(port_cache, f)
        assert (r is None) == (p is None), f
        if r is not None:
            assert tuple(p.shape) == r.shape and str(p.dtype) == f"torch.{r.dtype}", f
            assert _rel(_np(p.float()), r.astype(np.float32)) < rel, (f, _rel(_np(p.float()), r.astype(np.float32)))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch):
    cfg, ref, params = _port(arch)
    inp = torch.from_numpy(_inputs(cfg, ref["np_params"], ref["tokens"][:, :L]))
    logits, cache = pmodel.prefill(params, inp, cfg)
    r_logits, r_cache = ref["prefill"]
    assert logits.shape == r_logits.shape and logits.dtype == torch.float32
    assert _rel(_np(logits), r_logits) < REL_MODEL
    _assert_cache_equal(r_cache, cache, REL_MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Four decode steps from the reference's own prefill cache (carried by
    ``convert.model_cache``): every step's logits and the final cache."""
    cfg, ref, params = _port(arch)
    cache = convert.model_cache(ref["prefill"][1], device="cpu")
    for t in range(EXTRA):
        tok = torch.from_numpy(ref["tokens"][:, L + t : L + t + 1].astype(np.int64))  # int64 embeds too
        logits, cache = pmodel.decode_step(params, tok, cache, cfg)
        assert _rel(_np(logits), ref["steps"][t]) < REL_MODEL, t
    _assert_cache_equal(ref["cache"], cache, REL_MODEL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_matches_reference(arch):
    cfg, ref, params = _port(arch)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss = float(pmodel.train_loss(params, batch, cfg))
    assert abs(loss - ref["loss"]) / abs(ref["loss"]) < REL_LOSS


def _bf16_outputs(logits, cache, steps, final):
    """(name, array) of a run's outputs: prefill logits, each cache leaf
    after the prefill and after the last step, each step's logits."""
    out = [("prefill", logits)]
    out += [(f"prefill {f}", getattr(cache, f)) for f in ("k", "v", "conv", "ssd") if getattr(cache, f) is not None]
    out += [(f"step {t}", lg) for t, lg in enumerate(steps)]
    out += [(f"final {f}", getattr(final, f)) for f in ("k", "v", "conv", "ssd") if getattr(final, f) is not None]
    return [(n, _np(a.float()) if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)) for n, a in out]


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_prefill_and_decode_match_reference(arch):
    """In bf16: the reference's bf16 weights carried over bit for bit, then
    prefill logits, every cache leaf and four decode steps from the port's
    own cache, against the reference's bf16 run (REL_BF16) and against its
    float32 run on the same weights, which the port's bf16 must approach as
    closely as the reference's does (within twice its error). The top-1
    token of every step is the reference's."""
    cfg, ref, params = _port(arch, bf16=True)
    assert params["embed"].dtype == torch.bfloat16
    logits, cache = pmodel.prefill(params, torch.from_numpy(ref["tokens"][:, :L]), cfg)
    first, steps = cache._replace(**{f: getattr(cache, f).clone() for f in ("k", "v", "conv", "ssd") if getattr(cache, f) is not None}), []
    for t in range(EXTRA):
        lg, cache = pmodel.decode_step(params, torch.from_numpy(ref["tokens"][:, L + t : L + t + 1]), cache, cfg)
        assert lg.dtype == torch.float32
        steps.append(lg)
    port = _bf16_outputs(logits, first, steps, cache)
    (r_logits, r_cache), r_steps, r_final = ref["prefill"], ref["steps"], ref["cache"]
    bf = _bf16_outputs(r_logits, r_cache, r_steps, r_final)
    (a_logits, a_cache), a_steps, a_final = ref["anchor"]
    f32 = _bf16_outputs(a_logits, a_cache, a_steps, a_final)
    for (name, p), (_, r), (_, a) in zip(port, bf, f32, strict=True):
        assert p.shape == r.shape, name
        assert _rel(p, r) < REL_BF16, (name, _rel(p, r))
        assert _rel(p, a) <= 2 * _rel(r, a), (name, _rel(p, a), _rel(r, a))
        if p.ndim == 3:  # logits (B, 1, V)
            assert np.array_equal(p[:, -1].argmax(-1), r[:, -1].argmax(-1)), name


# --- full-size configs as shapes ---------------------------------------------


def _spec_leaves(tree, path=""):
    """[(path, shape, dtype name)] of a tree of meta tensors or ShapeDtypeStructs."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _spec_leaves(getattr(tree, f), f"{path}.{f}")]
    if tree is None:
        return []
    return [(path, tuple(tree.shape), str(tree.dtype).removeprefix("torch."))]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_shapes_and_counts_match_reference(arch):
    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    assert pmodel.param_shapes(pcfg) == rmodel.param_shapes(rcfg)
    port = pmodel.abstract_params(pcfg)
    assert all(t.device.type == "meta" for _, t in _flat(port))
    assert _spec_leaves(port) == _spec_leaves(rmodel.abstract_params(rcfg))
    assert pcfg.param_count() == rcfg.param_count()
    assert pcfg.active_param_count() == rcfg.active_param_count()
    assert pcfg.padded_vocab == rcfg.padded_vocab and pcfg.head_dim == rcfg.head_dim
    assert pmodel.cache_shapes(pcfg, 128, 32768) == rmodel.cache_shapes(rcfg, 128, 32768)
    assert _spec_leaves(pmodel.abstract_cache(pcfg, 4, 1040)) == _spec_leaves(rmodel.abstract_cache(rcfg, 4, 1040))


def _flat(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v)
        else:
            yield k, v


def test_cells_match_reference():
    for skipped in (False, True):
        assert pconfigs.cells(include_skipped=skipped) == rconfigs.cells(include_skipped=skipped)
    assert pconfigs.ARCH_IDS == rconfigs.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in pconfigs.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in rconfigs.SHAPES.items()
    }


@pytest.mark.parametrize("arch,shape,_skipped", rconfigs.cells(include_skipped=True))
def test_input_specs_match_reference(arch, shape, _skipped):
    port = pspecs.input_specs(arch, shape)
    assert _spec_leaves(port) == _spec_leaves(rspecs.input_specs(arch, shape))
    assert pspecs.model_flops(arch, shape) == rspecs.model_flops(arch, shape)


# --- full width, depth 1 -------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b"])
def test_full_width_depth1_matches_reference(arch):
    """The published widths (vocab 151,936 / 50,280, d_model 1536 / 2560)
    with one layer in float32, B = 1 x 16 tokens: prefill and one decode."""
    rcfg = dataclasses.replace(
        rconfigs.get_config(arch), num_layers=1, cache_pad=4, dtype=jnp.float32, param_dtype=jnp.float32
    )
    pcfg = dataclasses.replace(
        pconfigs.get_config(arch), num_layers=1, cache_pad=4, dtype=torch.float32, param_dtype=torch.float32
    )
    rparams = rmodel.init_params(rcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, rparams)
    params = convert.model_params(np_params, device="cpu")
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab_size, (1, 17)).astype(np.int32)
    r_logits, r_cache = rmodel.prefill(rparams, jnp.asarray(tokens[:, :16]), rcfg)
    r_step, _ = rmodel.decode_step(rparams, jnp.asarray(tokens[:, 16:]), r_cache, rcfg)
    del rparams
    logits, cache = pmodel.prefill(params, torch.from_numpy(tokens[:, :16]), pcfg)
    assert _rel(_np(logits), np.asarray(r_logits)) < REL_MODEL
    _assert_cache_equal(jax.tree.map(np.asarray, r_cache), cache, REL_MODEL)
    step, _ = pmodel.decode_step(params, torch.from_numpy(tokens[:, 16:]), cache, pcfg)
    assert _rel(_np(step), np.asarray(r_step)) < REL_MODEL


# --- decoding past the cache ---------------------------------------------------


def test_decode_past_cache_raises_where_reference_clamps():
    """Reduced qwen2, prefill of 8 tokens with cache_pad = 0, then one decode
    step: the cache is full. The port raises; the reference clamps the
    write onto the last slot (``dynamic_update_slice``) and its logits
    differ from a full prefill of the 9 tokens. With cache_pad = 4 both
    agree with the full prefill. This fails if the reference changes."""
    ref = _reference_run("qwen2-1.5b")
    tokens = ref["tokens"][:, :9]
    rparams = jax.tree.map(jnp.asarray, ref["np_params"])
    rcfg = rconfigs.reduce_for_smoke(rconfigs.get_config("qwen2-1.5b"))
    pcfg = pconfigs.reduce_for_smoke(pconfigs.get_config("qwen2-1.5b"))
    params = convert.model_params(ref["np_params"], device="cpu")
    full = np.asarray(rmodel.prefill(rparams, jnp.asarray(tokens), rcfg)[0])

    errs = {}
    for pad in (0, 4):
        rc = dataclasses.replace(rcfg, cache_pad=pad)
        _, cache = rmodel.prefill(rparams, jnp.asarray(tokens[:, :8]), rc)
        step, _ = rmodel.decode_step(rparams, jnp.asarray(tokens[:, 8:]), cache, rc)
        errs[pad] = _rel(np.asarray(step), full)
    assert errs[0] > 1e-2 and errs[4] < REL_MODEL, errs

    _, cache = pmodel.prefill(params, torch.from_numpy(tokens[:, :8]), dataclasses.replace(pcfg, cache_pad=0))
    assert cache.k.shape[2] == 8 and cache.length == 8
    with pytest.raises(ValueError, match="decode past the cache"):
        pmodel.decode_step(params, torch.from_numpy(tokens[:, 8:]), cache, pcfg)
    p4 = dataclasses.replace(pcfg, cache_pad=4)
    _, cache = pmodel.prefill(params, torch.from_numpy(tokens[:, :8]), p4)
    step, cache = pmodel.decode_step(params, torch.from_numpy(tokens[:, 8:]), cache, p4)
    assert _rel(_np(step), full) < REL_MODEL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b", "zamba2-2.7b"])
def test_decode_from_a_used_cache_raises(arch):
    """A decode step writes K/V and SSM states into the cache's tensors and
    so uses the cache up: decoding again from the kept prefill cache raises
    (its SSM states have moved on; the reference's functional decode would
    answer from it, as the last lines show), and the returned cache goes on
    decoding, equal to the reference's steps."""
    cfg, ref, params = _port(arch)
    tokens = torch.from_numpy(ref["tokens"])
    _, cache0 = pmodel.prefill(params, tokens[:, :L], cfg)
    _, cache1 = pmodel.decode_step(params, tokens[:, L : L + 1], cache0, cfg)
    with pytest.raises(ValueError, match="stale cache"):
        pmodel.decode_step(params, tokens[:, L : L + 1], cache0, cfg)
    logits, _ = pmodel.decode_step(params, tokens[:, L + 1 : L + 2], cache1, cfg)
    assert _rel(_np(logits), ref["steps"][1]) < REL_MODEL

    rcfg = _reduced(rconfigs, arch, None)
    rparams = jax.tree.map(jnp.asarray, ref["np_params"])
    _, r_cache = rmodel.prefill(rparams, jnp.asarray(ref["tokens"][:, :L]), rcfg)
    again = [np.asarray(rmodel.decode_step(rparams, jnp.asarray(ref["tokens"][:, L : L + 1]), r_cache, rcfg)[0]) for _ in range(2)]
    assert np.array_equal(again[0], again[1])


def test_forward_holds_reference_matmul_flags():
    """A forward runs with TF32 and bf16 reduced-precision reductions off
    (PyTorch's default for the latter is on), and gives the caller's flags
    back after."""
    from repro_torch.models import transformer

    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    seen = []
    real = transformer._forward

    def spy(*a, **kw):
        seen.append((m.allow_tf32, m.allow_bf16_reduced_precision_reduction))
        return real(*a, **kw)

    cfg, ref, params = _port("qwen2-1.5b")
    try:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = True, True
        with mock.patch.object(transformer, "_forward", spy):
            pmodel.prefill(params, torch.from_numpy(ref["tokens"][:, :8]), cfg)
        assert seen == [(False, False)]
        assert (m.allow_tf32, m.allow_bf16_reduced_precision_reduction) == (True, True)
    finally:
        m.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def test_model_params_reads_bfloat16_leaves():
    """A bfloat16 reference leaf (ml_dtypes) arrives as bfloat16, bit for
    bit; ``dtype=`` casts every leaf."""
    x = np.asarray(jnp.asarray([1.0, -2.5, 3.0078125, 1e-3], jnp.bfloat16))
    tree = {"embed": x, "layers": {"wq": np.ones((2, 3), np.float32)}}
    out = convert.model_params(tree, device="cpu")
    assert out["embed"].dtype == torch.bfloat16 and out["layers"]["wq"].dtype == torch.float32
    assert np.array_equal(out["embed"].float().numpy(), x.astype(np.float32))
    cast = convert.model_params(tree, device="cpu", dtype=torch.float32)
    assert cast["embed"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "arctic-480b"])
def test_lm_module_paths_and_forward(arch):
    """``LM``'s ``state_dict()`` keys are the reference's parameter paths,
    its leaves the tree's, and its forward the functional one: to float32
    rounding, since ``torch.matmul`` folds a batched product into one GEMM
    only for operands that do not require grad (a Parameter does)."""
    cfg, ref, params = _port(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(ref["np_params"])
    paths = {".".join(k.key for k in path): leaf for path, leaf in flat}
    lm = pmodel.LM(cfg, params)
    sd = lm.state_dict()
    assert sorted(sd) == sorted(paths)
    assert all(np.array_equal(sd[k].numpy(), v) for k, v in paths.items())
    inp = torch.from_numpy(_inputs(cfg, ref["np_params"], ref["tokens"][:, :L]))
    with torch.no_grad():
        logits, _, _ = lm(inp, mode="prefill")
    assert _rel(_np(logits), _np(pmodel.prefill(params, inp, cfg)[0])) < REL_LOSS


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_frontend_specs_match_reference(arch):
    from repro.models import frontends as rfront
    from repro_torch.models import frontends as pfront

    rcfg, pcfg = rconfigs.get_config(arch), pconfigs.get_config(arch)
    assert _spec_leaves(pfront.embedding_spec(pcfg, 2, 7)) == _spec_leaves(rfront.embedding_spec(rcfg, 2, 7))
    emb = pfront.synthetic_embeddings(pconfigs.reduce_for_smoke(pcfg), 2, 7, seed=3, device="cpu")
    again = pfront.synthetic_embeddings(pconfigs.reduce_for_smoke(pcfg), 2, 7, seed=3, device="cpu")
    assert emb.shape == (2, 7, 128) and emb.dtype == torch.float32 and torch.equal(emb, again)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b", "zamba2-2.7b"])
def test_init_cache_matches_reference_and_decodes_from_empty(arch):
    """``init_cache`` leaves (zeros) equal the reference's; decoding 3 tokens
    into an empty cache gives the logits of a prefill of those 3 tokens
    (float32: 1e-4 relative)."""
    cfg, ref, params = _port(arch)
    rcfg = rconfigs.reduce_for_smoke(rconfigs.get_config(arch))
    cache = pmodel.init_cache(cfg, B, 8, device="cpu")
    _assert_cache_equal(jax.tree.map(np.asarray, rmodel.init_cache(rcfg, B, 8)), cache, REL_MODEL)
    assert all(float(getattr(cache, f).abs().max()) == 0 for f in ("k", "v", "conv", "ssd") if getattr(cache, f) is not None)
    tokens = torch.from_numpy(ref["tokens"][:, :3])
    for t in range(3):
        logits, cache = pmodel.decode_step(params, tokens[:, t : t + 1], cache, cfg)
    assert cache.length == 3
    assert _rel(_np(logits), _np(pmodel.prefill(params, tokens, cfg)[0])) < REL_MODEL
