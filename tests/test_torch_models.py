"""repro_torch.models: the cases of tests/test_models.py on the port, and
each module held to repro.models on the same numpy inputs.

The first block runs the reference's smoke tests under their names on the
port alone (its own torch-seeded parameters), for all ten reduced configs.
The second feeds numpy-seeded inputs (and random norms, biases and SSM
parameters, which the models' init leaves at constants) through both
packages' functions on the CPU.

Tolerances, as max abs difference over the reference's max abs value:
float32 in both, the same operations in different orders (XLA vs
PyTorch's BLAS), so 1e-5 for one layer or one module; the reference tests'
own bounds where a case is theirs (2e-3 decode vs full, 2e-5 against a
naive attention, 3e-4 chunked vs sequential SSD). Integers (routing
choices, slots, counts) exact. bf16 attention (the serving dtype, where
the reference pre-scales q in bf16 and rounds p to bf16 before the PV
product): 1e-3, a quarter of one bf16 step (2^-8) at the largest output;
measured on the CPU, at most 1.9e-4 (one output one step apart), most
cases bit-equal.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ratt
from repro.models import layers as rlay
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro_torch.configs import ARCH_IDS, cells, get_config, reduce_for_smoke
from repro_torch.models import attention, layers, model, moe, ssm

REL = 1e-5
REL_BF16 = 1e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tokens(cfg, b, l, seed=0):
    return _t(np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, l)).astype(np.int32))


def _inputs(cfg, params, tokens):
    if cfg.embeds_input:
        return params["embed"][tokens.long()]
    return tokens


# --- tests/test_models.py, on the port -------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step(arch):
    cfg = reduce_for_smoke(get_config(arch))
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    leaves = [p.requires_grad_() for p in _leaves(params)]
    b, l = 2, 64
    tokens = _tokens(cfg, b, l)
    batch = {"labels": tokens}
    if cfg.embeds_input:
        batch["embeds"] = _inputs(cfg, params, tokens).detach()
    else:
        batch["tokens"] = tokens
    loss = model.train_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert np.isfinite(float(loss.detach()))
    gn = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads if g is not None)))
    assert np.isfinite(gn) and gn > 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_shapes(arch):
    cfg = reduce_for_smoke(get_config(arch))
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    b, l = 2, 64
    tokens = _tokens(cfg, b, l)
    logits, cache = model.prefill(params, _inputs(cfg, params, tokens), cfg)
    assert logits.shape == (b, 1, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    assert int(cache.length) == l


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_full_forward(arch):
    """Incremental decode == full forward (KV cache / SSM state correctness)."""
    cfg = reduce_for_smoke(get_config(arch))
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    b, l, extra = 2, 64, 4
    tokens = _tokens(cfg, b, l + extra)
    _, cache = model.prefill(params, _inputs(cfg, params, tokens[:, :l]), cfg)
    lg = None
    for t in range(extra):
        lg, cache = model.decode_step(params, tokens[:, l + t : l + t + 1], cache, cfg)
    full, _ = model.prefill(params, _inputs(cfg, params, tokens), cfg)
    a, bb = lg.numpy()[:, 0], full.numpy()[:, 0]
    err = np.max(np.abs(a - bb) / (np.abs(bb).max() + 1e-6))
    assert err < 2e-3, err


def test_param_counts_reasonable():
    """Full configs must land near their nameplate sizes."""
    expect = {
        "grok-1-314b": (250e9, 380e9),
        "arctic-480b": (400e9, 560e9),
        "command-r-35b": (30e9, 42e9),
        "granite-3-8b": (6e9, 10e9),
        "qwen2-1.5b": (1.2e9, 2.0e9),
        "gemma3-12b": (9e9, 14e9),
        "mamba2-2.7b": (2.2e9, 3.3e9),
        "zamba2-2.7b": (2.2e9, 3.5e9),
    }
    for arch, (lo, hi) in expect.items():
        n = get_config(arch).param_count()
        assert lo <= n <= hi, (arch, n)


def test_cells_registry():
    all_cells = cells(include_skipped=True)
    assert len(all_cells) == 40  # 10 archs x 4 shapes
    runnable = [c for c in all_cells if not c[2]]
    assert len(runnable) == 33  # long_500k runs only for 3 sub-quadratic archs
    skipped = {(a, s) for a, s, sk in all_cells if sk}
    assert all(s == "long_500k" for _, s in skipped)


def _moe_weights(seed, t, d, e, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d), dtype=np.float32)
    router = rng.standard_normal((d, e), dtype=np.float32)
    wg, wu = (rng.standard_normal((e, d, f), dtype=np.float32) * 0.1 for _ in range(2))
    wd = rng.standard_normal((e, f, d), dtype=np.float32) * 0.1
    return x, router, wg, wu, wd


def test_moe_capacity_drops_counted():
    t, d, e, f = 64, 16, 4, 32
    args = [_t(a) for a in _moe_weights(1, t, d, e, f)]
    out = moe.moe_ffn(*args, top_k=2, capacity_factor=0.5)
    assert 0.0 < float(out.dropped_frac) < 1.0
    assert np.isfinite(float(out.aux_loss))
    out2 = moe.moe_ffn(*args, top_k=2, capacity_factor=8.0)
    assert float(out2.dropped_frac) == 0.0


def test_moe_grouping_invariance():
    """Group count changes capacity locality, not drop-free results."""
    t, d, e, f = 128, 16, 4, 32
    args = [_t(a) for a in _moe_weights(2, t, d, e, f)]
    y1 = moe.moe_ffn(*args, top_k=2, capacity_factor=16.0, num_groups=1)
    y4 = moe.moe_ffn(*args, top_k=2, capacity_factor=16.0, num_groups=4)
    np.testing.assert_allclose(y1.y.numpy(), y4.y.numpy(), atol=1e-5)


def _qkv(seed, b, l, h, kv, hd):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, l, h, hd), dtype=np.float32),
        rng.standard_normal((b, l, kv, hd), dtype=np.float32),
        rng.standard_normal((b, l, kv, hd), dtype=np.float32),
    )


def test_flash_attention_matches_naive():
    b, l, h, kv, hd = 2, 128, 4, 2, 16
    q, k, v = _qkv(3, b, l, h, kv, hd)
    out = attention.flash_attention(_t(q), _t(k), _t(v), causal=True, kv_chunk=32).numpy()
    kk, vv = np.repeat(k, h // kv, axis=2), np.repeat(v, h // kv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, kk) / np.sqrt(hd)
    s = np.where(np.tril(np.ones((l, l), bool))[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref_out = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), vv)
    np.testing.assert_allclose(out, ref_out, atol=2e-5)


def test_sliding_window_mask():
    b, l, h, hd, w = 1, 64, 2, 8, 8
    q, k, v = _qkv(4, b, l, h, h, hd)
    out_w = attention.flash_attention(_t(q), _t(k), _t(v), causal=True, window=w, kv_chunk=16).numpy()
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    qi = np.arange(l)
    mask = (qi[:, None] >= qi[None, :]) & (qi[:, None] - qi[None, :] < w)
    s = np.where(mask[None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref_out = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(out_w, ref_out, atol=2e-5)
    # is_global=True must disable the window
    out_g = attention.flash_attention(_t(q), _t(k), _t(v), causal=True, window=w, is_global=True, kv_chunk=16)
    out_full = attention.flash_attention(_t(q), _t(k), _t(v), causal=True, kv_chunk=16)
    np.testing.assert_allclose(out_g.numpy(), out_full.numpy(), atol=1e-6)


def test_ssd_chunked_matches_sequential():
    """Chunked SSD == token-by-token recurrence."""
    cfg = reduce_for_smoke(get_config("mamba2-2.7b"))
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    p = {k: v[0] for k, v in params["layers"].items() if k != "ln1"}
    b, l = 1, 64
    u = _t(np.random.default_rng(5).standard_normal((b, l, cfg.d_model), dtype=np.float32) * 0.5)
    y_chunk, st = ssm.ssm_forward(p, u, cfg, return_state=True)
    dims = ssm.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv)
    state = ssm.SSMState(
        conv=torch.zeros((b, dims["conv_k"] - 1, dims["conv_dim"])),
        ssd=torch.zeros((b, dims["nheads"], dims["headdim"], dims["state"])),
    )
    outs = []
    for t in range(l):
        o, state = ssm.ssm_decode_step(p, u[:, t], state, cfg)
        outs.append(o)
    y_seq = torch.stack(outs, dim=1)
    np.testing.assert_allclose(y_chunk.numpy(), y_seq.numpy(), atol=3e-4)
    np.testing.assert_allclose(st.ssd.numpy(), state.ssd.numpy(), atol=3e-4)


# --- module parity against repro.models -----------------------------------------


def test_layers_match_reference():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 32), dtype=np.float32)
    w = rng.standard_normal((32,), dtype=np.float32) * 0.3
    assert _rel(layers.rms_norm(_t(x), _t(w)), rlay.rms_norm(jnp.asarray(x), jnp.asarray(w))) < REL

    wm = rng.standard_normal((32, 24), dtype=np.float32)
    bias = rng.standard_normal((24,), dtype=np.float32)
    assert _rel(layers.dense(_t(x), _t(wm), _t(bias)), rlay.dense(*map(jnp.asarray, (x, wm, bias)))) < REL

    g, u, d = (rng.standard_normal(s, dtype=np.float32) * 0.2 for s in ((32, 48), (32, 48), (48, 32)))
    assert _rel(layers.swiglu(*map(_t, (x, g, u, d))), rlay.swiglu(*map(jnp.asarray, (x, g, u, d)))) < REL

    qh = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    for theta in (10000.0, 1_000_000.0):
        assert _rel(layers.rope(_t(qh), _t(pos), theta), rlay.rope(jnp.asarray(qh), jnp.asarray(pos), theta)) < REL

    logits = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)
    ce = float(layers.softmax_cross_entropy(_t(logits), _t(labels), 50))
    ref = float(rlay.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 50))
    assert abs(ce - ref) / abs(ref) < REL

    table = rng.standard_normal((64, 8), dtype=np.float32)
    for idt in (np.int32, np.int64):
        tok = labels.astype(idt)
        assert np.array_equal(layers.embed(_t(tok), _t(table), torch.float32).numpy(), table[tok])
    assert _rel(layers.unembed(_t(x[..., :8]), _t(table)), rlay.unembed(jnp.asarray(x[..., :8]), jnp.asarray(table))) < REL


FLASH_CASES = {
    # name: (b, lq, h, kv, hd, kv_chunk, window, is_global, q_offset, kv_valid)
    "causal_gqa": (2, 64, 4, 2, 16, 16, 0, None, 0, None),
    "ragged_chunk": (1, 50, 4, 1, 8, 16, 0, None, 0, None),
    "sliding_window": (1, 48, 2, 2, 8, 16, 8, None, 0, None),
    "window_is_global_true": (1, 48, 2, 2, 8, 16, 8, True, 0, None),
    "window_is_global_false": (1, 48, 2, 2, 8, 16, 8, False, 0, None),
    "offset_and_valid": (1, 40, 4, 2, 8, 16, 0, None, 5, 33),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    b, lq, h, kv, hd, chunk, window, flag, q_offset, kv_valid = FLASH_CASES[case]
    q, k, v = _qkv(11, b, lq, h, kv, hd)
    kw = dict(causal=True, window=window, q_offset=q_offset, kv_chunk=chunk)
    ref = ratt.flash_attention(
        *map(jnp.asarray, (q, k, v)), **kw,
        is_global=None if flag is None else jnp.asarray(flag),
        kv_valid=None if kv_valid is None else jnp.int32(kv_valid),
    )
    port = attention.flash_attention(
        *map(_t, (q, k, v)), **kw,
        is_global=None if flag is None else torch.tensor(flag), kv_valid=kv_valid,
    )
    assert port.shape == ref.shape and port.dtype == torch.float32
    assert _rel(port, ref) < REL


def _bf16(*arrays):
    """Each float32 array rounded to bfloat16, for both packages: (jax, torch)."""
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    return j, [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in j]


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_bf16_matches_reference(case):
    b, lq, h, kv, hd, chunk, window, flag, q_offset, kv_valid = FLASH_CASES[case]
    (rq, rk, rv), (pq, pk, pv) = _bf16(*_qkv(11, b, lq, h, kv, hd))
    kw = dict(causal=True, window=window, q_offset=q_offset, kv_chunk=chunk)
    ref = ratt.flash_attention(
        rq, rk, rv, **kw, is_global=None if flag is None else jnp.asarray(flag),
        kv_valid=None if kv_valid is None else jnp.int32(kv_valid),
    )
    port = attention.flash_attention(
        pq, pk, pv, **kw, is_global=None if flag is None else torch.tensor(flag), kv_valid=kv_valid,
    )
    assert port.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _rel(port.float(), ref.astype(jnp.float32)) < REL_BF16


@pytest.mark.parametrize("window,flag", [(0, None), (6, None), (6, True), (6, False)])
def test_decode_attention_matches_reference(window, flag):
    rng = np.random.default_rng(12)
    b, s, h, kv, hd, length = 2, 24, 4, 2, 16, 17
    q = rng.standard_normal((b, 1, h, hd), dtype=np.float32)
    ck = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    cv = rng.standard_normal((b, s, kv, hd), dtype=np.float32)
    ref = ratt.decode_attention(
        *map(jnp.asarray, (q, ck, cv)), jnp.int32(length), window=window,
        is_global=None if flag is None else jnp.asarray(flag),
    )
    port = attention.decode_attention(
        *map(_t, (q, ck, cv)), length, window=window,
        is_global=None if flag is None else torch.tensor(flag),
    )
    assert _rel(port, ref) < REL


@pytest.mark.parametrize("window,flag", [(0, None), (6, True)])
def test_decode_attention_bf16_matches_reference(window, flag):
    rng = np.random.default_rng(13)
    b, s, h, kv, hd, length = 2, 24, 4, 2, 16, 17
    (rq, rk, rv), (pq, pk, pv) = _bf16(
        rng.standard_normal((b, 1, h, hd), dtype=np.float32),
        *(rng.standard_normal((b, s, kv, hd), dtype=np.float32) for _ in range(2)),
    )
    flag_j, flag_t = (None, None) if flag is None else (jnp.asarray(flag), torch.tensor(flag))
    ref = ratt.decode_attention(rq, rk, rv, jnp.int32(length), window=window, is_global=flag_j)
    port = attention.decode_attention(pq, pk, pv, length, window=window, is_global=flag_t)
    assert port.dtype == torch.bfloat16
    assert _rel(port.float(), ref.astype(jnp.float32)) < REL_BF16


def test_sharding_arguments_are_not_taken():
    """The reference's placement arguments are not ported: passing one is a
    TypeError, not a silent no-op. An MoE config with a mesh injected routes
    one group per data-parallel shard, as the reference does (the groups'
    arithmetic is held to the reference in test_torch_train.py); at the
    reduced config's drop-free capacity the groups change no token's route."""
    q, k, v = map(_t, _qkv(3, 1, 8, 2, 2, 8))
    with pytest.raises(TypeError):
        attention.flash_attention(q, k, v, attn_shard="seq")
    args = [_t(a) for a in _moe_weights(1, 16, 16, 4, 32)]
    with pytest.raises(TypeError):
        moe.moe_ffn(*args, top_k=2, ep_axis="model")
    cfg = reduce_for_smoke(get_config("grok-1-314b"))
    meshed = dataclasses.replace(
        cfg, mesh_dp=("data",), mesh_model="model", mesh_axis_sizes=(("data", 2), ("model", 2))
    )
    params = model.init_params(cfg, generator=_gen(), device="cpu")
    tokens = _tokens(cfg, 2, 8)
    plain = model.prefill(params, tokens, cfg)[0]
    assert torch.isfinite(plain).all()
    with mock.patch.object(moe, "moe_ffn", wraps=moe.moe_ffn) as spy:
        grouped = model.prefill(params, tokens, meshed)[0]
    assert {c.kwargs["num_groups"] for c in spy.call_args_list} == {2}
    assert _rel(grouped, plain) < REL


def _reference_routing(x, router, top_k, cap, g):
    """The routing of ``repro/models/moe.py`` (lines 69-97) run in JAX:
    ``moe_ffn`` returns only its result, so its choices and slots are
    recomputed here with the reference's own operations."""
    t, d = x.shape
    xg = jnp.asarray(x).reshape(g, t // g, d)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, jnp.asarray(router)), axis=-1)
    gate, expert = jax.lax.top_k(probs, top_k)
    tk = (t // g) * top_k
    gi = jnp.arange(g, dtype=jnp.int32)[:, None]
    flat_e = expert.reshape(g, tk)
    order = jnp.argsort(flat_e, axis=-1, stable=True)
    counts = jnp.zeros((g, router.shape[1]), jnp.int32).at[gi, flat_e].add(1)
    starts = jnp.cumsum(counts, axis=-1) - counts
    sorted_e = jnp.take_along_axis(flat_e, order, axis=-1)
    pos_sorted = jnp.arange(tk, dtype=jnp.int32)[None, :] - jnp.take_along_axis(starts, sorted_e, axis=-1)
    pos = jnp.zeros((g, tk), jnp.int32).at[gi, order].set(pos_sorted)
    keep = pos < cap
    return np.asarray(expert), np.asarray(jnp.where(keep, pos, cap)), np.asarray(keep)


@pytest.mark.parametrize("cf,groups", [(8.0, 1), (0.5, 1), (1.25, 4), (0.5, 4)])
def test_moe_ffn_matches_reference(cf, groups):
    t, d, e, f, k = 96, 16, 4, 32, 2
    x, router, wg, wu, wd = _moe_weights(13, t, d, e, f)
    ref = rmoe.moe_ffn(*map(jnp.asarray, (x, router, wg, wu, wd)), top_k=k, capacity_factor=cf, num_groups=groups)
    port = moe.moe_ffn(*map(_t, (x, router, wg, wu, wd)), top_k=k, capacity_factor=cf, num_groups=groups)
    assert _rel(port.y, ref.y) < REL
    assert abs(float(port.aux_loss) - float(ref.aux_loss)) <= REL * abs(float(ref.aux_loss))
    assert float(port.dropped_frac) == float(ref.dropped_frac)
    assert (float(ref.dropped_frac) > 0) == (cf < 1)

    cap = max(int(cf * k * (t // groups) / e), k, 1)
    r = moe.route(_t(x).reshape(groups, t // groups, d), _t(router), top_k=k, cap=cap)
    expert, slot, keep = _reference_routing(x, router, k, cap, groups)
    assert np.array_equal(r.expert.numpy(), expert)
    assert np.array_equal(r.slot.numpy(), slot) and np.array_equal(r.keep.numpy(), keep)


def _ssm_params(cfg, seed):
    """One Mamba2 layer with every leaf random (the init sets several to
    constants)."""
    rng = np.random.default_rng(seed)
    shapes = {k: s[1:] for k, s in model.param_shapes(cfg)["layers"].items() if k != "ln1"}
    p = {k: rng.standard_normal(s, dtype=np.float32) * (s[-2] if len(s) > 1 else 4) ** -0.5 for k, s in shapes.items()}
    p["a_log"] = rng.uniform(-1, 1, shapes["a_log"]).astype(np.float32)
    p["dt_bias"] = rng.uniform(-3, 0, shapes["dt_bias"]).astype(np.float32)
    return p


@pytest.mark.parametrize("l", [64, 45])
def test_ssm_forward_matches_reference(l):
    """Chunked SSD with the state; 45 pads the last chunk."""
    cfg = reduce_for_smoke(get_config("mamba2-2.7b"))
    p = _ssm_params(cfg, 14)
    u = np.random.default_rng(15).standard_normal((2, l, cfg.d_model), dtype=np.float32) * 0.5
    ry, rst = rssm.ssm_forward({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(u), cfg, return_state=True)
    py, pst = ssm.ssm_forward({k: _t(v) for k, v in p.items()}, _t(u), cfg, return_state=True)
    assert _rel(py, ry) < REL
    assert _rel(pst.conv, rst.conv) < REL and _rel(pst.ssd, rst.ssd) < REL


def test_ssm_decode_step_matches_reference():
    cfg = reduce_for_smoke(get_config("mamba2-2.7b"))
    p = _ssm_params(cfg, 16)
    dims = ssm.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_conv)
    rng = np.random.default_rng(17)
    u = rng.standard_normal((2, cfg.d_model), dtype=np.float32)
    conv = rng.standard_normal((2, dims["conv_k"] - 1, dims["conv_dim"]), dtype=np.float32)
    ssd = rng.standard_normal((2, dims["nheads"], dims["headdim"], dims["state"]), dtype=np.float32)
    ry, rst = rssm.ssm_decode_step(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(u), rssm.SSMState(jnp.asarray(conv), jnp.asarray(ssd)), cfg
    )
    py, pst = ssm.ssm_decode_step({k: _t(v) for k, v in p.items()}, _t(u), ssm.SSMState(_t(conv), _t(ssd)), cfg)
    assert _rel(py, ry) < REL
    # the window's kept rows are copies; its new row is the in_proj output
    assert np.array_equal(pst.conv[:, :-1].numpy(), conv[:, 1:])
    assert _rel(pst.conv, rst.conv) < REL and _rel(pst.ssd, rst.ssd) < REL
