"""The port's kernel autotuner (``kernels/tuning.py``) and its persistent cache.

The 18 cases of ``tests/test_tuning.py`` on the port, with its own
constants (``TUNE_TILES``, ``RESIDENT_NB_CEILING`` were measured on the
H100): deterministic sweeps through a fake ``hybrid._measure``, cache hit /
miss / stale / corrupt through ``calib_cache``'s generic entries in
``tmp_path`` files, and the determinism contract (the default policy never
touches the cache). Then parity with the reference: the same fake
measurements over the same explicit candidates give the same winner, the
same sequence of timed kinds, and byte-identical cache files.
"""

import json

import numpy as np
import pytest

from repro.core import calib_cache as jax_cache
from repro.core import hybrid as jax_hybrid
from repro.kernels import tuning as jax_tuning
from repro_torch.core import build as build_mod
from repro_torch.core import calib_cache, hybrid, registry
from repro_torch.kernels import ops, tuning
from torch_parity_util import to_np

N = 1 << 12
# An n whose nb (bs = 128) the resident fetch still serves.
N_RES = min(N, tuning.RESIDENT_NB_CEILING * 128)


def _fail_measure(*a, **k):
    pytest.fail("timing sweep ran despite a warm cache / default policy")


# --- candidate product -------------------------------------------------------


def test_candidate_configs_pinned_block_size():
    cands = tuning.candidate_configs(N_RES, 128)
    assert all(c.block_size == 128 for c in cands)
    assert len(cands) == len(set(cands)) == len(tuning.TUNE_TILES) * 2
    # The resolved default is always a member (the winner can't lose to it).
    default = tuning.KernelConfig(tuning.DEFAULT_TILE, tuning.resolve_fetch("auto", -(-N_RES // 128)), 128)
    assert default in cands


def test_candidate_configs_exclude_resident_past_ceiling():
    n = (tuning.RESIDENT_NB_CEILING + 1) * 128  # nb just past the ceiling
    cands = tuning.candidate_configs(n, 128)
    assert cands and all(c.fetch == "dma" for c in cands)
    assert tuning.KernelConfig(tuning.DEFAULT_TILE, "dma", 128) in cands


def test_candidate_configs_sweep_block_sizes_by_default():
    cands = tuning.candidate_configs(N)
    assert {c.block_size for c in cands} == set(tuning.TUNE_BLOCK_SIZES)


def test_resolve_fetch():
    assert tuning.resolve_fetch("auto", tuning.RESIDENT_NB_CEILING) == "resident"
    assert tuning.resolve_fetch("auto", tuning.RESIDENT_NB_CEILING + 1) == "dma"
    assert tuning.resolve_fetch("dma", 4) == "dma"
    with pytest.raises(ValueError):
        tuning.resolve_fetch("mmap", 4)


def test_candidate_configs_layout_axis_has_only_kernel_paths():
    cands = tuning.candidate_configs(N_RES, 128, layouts=tuning.TUNE_LAYOUTS)
    assert {c.layout for c in cands} == {"unpacked", "packed32", "quantized"}
    assert not any(c.layout == "quantized" and c.fetch == "dma" for c in cands)
    assert all(1 <= c.tile <= tuning.MAX_TILE for c in cands)
    assert set(tuning.TUNE_TILES) <= set(range(1, tuning.MAX_TILE + 1))


# --- key + entry schema ------------------------------------------------------


def test_tuning_key_namespace_and_fields():
    key = tuning.tuning_key(65536, 4096, backend="cuda", n_devices=1)
    assert key == "kernel/n=65536/batch=4096/backend=cuda/ndev=1"
    assert not key.startswith("n=")  # disjoint from the threshold keys
    others = {
        tuning.tuning_key(65537, 4096, backend="cuda", n_devices=1),
        tuning.tuning_key(65536, 2048, backend="cuda", n_devices=1),
        tuning.tuning_key(65536, 4096, backend="cpu", n_devices=1),
        tuning.tuning_key(65536, 4096, backend="cuda", n_devices=4),
    }
    assert key not in others and len(others) == 4
    # The defaults come from torch: this machine's backend and count.
    backend, n_devices = calib_cache.machine()
    assert tuning.tuning_key(65536) == tuning.tuning_key(
        65536, 4096, backend=backend, n_devices=n_devices
    )


def test_config_from_entry_rejects_malformed():
    good = {"tile": 8, "fetch": "dma", "block_size": 128}
    assert tuning.config_from_entry(good) == tuning.KernelConfig(8, "dma", 128)
    assert tuning.config_from_entry({**good, "tile": 32}) == tuning.KernelConfig(32, "dma", 128)
    for bad in (
        None,
        41,
        "dma",
        {"tile": 8},
        {"tile": 8, "fetch": "mmap", "block_size": 128},
        {"tile": 0, "fetch": "dma", "block_size": 128},
        {"tile": 33, "fetch": "dma", "block_size": 128},  # past the launch limit
        {"tile": 8, "fetch": "dma", "block_size": 100},
        {"tile": "x", "fetch": "dma", "block_size": 128},
        {"tile": 8, "fetch": "dma", "block_size": 128, "layout": "packed16"},
    ):
        assert tuning.config_from_entry(bad) is None, bad


# --- sweep + autotune via the fake timing seam -------------------------------


def _fake_measure_preferring(want):
    """A deterministic _measure: the wanted config times fastest."""

    def fake(kind, fn, lj, rj, repeats):
        tag = f"kernel/tile={want.tile}/fetch={want.fetch}/bs={want.block_size}"
        return 0.5 if kind == tag else 1.0

    return fake


def test_autotune_picks_the_fastest_candidate(monkeypatch):
    want = tuning.KernelConfig(tuning.TUNE_TILES[-1], "dma", 128)
    monkeypatch.setattr(hybrid, "_measure", _fake_measure_preferring(want))
    assert tuning.autotune(N, 64, block_size=128, device="cpu") == want


def test_autotune_tie_breaks_deterministically(monkeypatch):
    """All-equal timings: the first candidate in product order wins."""
    monkeypatch.setattr(hybrid, "_measure", lambda *a, **k: 1.0)
    cands = tuning.candidate_configs(N, 128)
    assert tuning.autotune(N, 64, block_size=128, device="cpu") == cands[0]


def test_sweep_times_every_candidate_through_the_seam(monkeypatch):
    seen = []
    monkeypatch.setattr(hybrid, "_measure", lambda kind, *a, **k: seen.append(kind) or 1.0)
    results = tuning.sweep(N, 64, block_size=128, device="cpu")
    assert len(results) == len(seen) == len(tuning.candidate_configs(N, 128))


def test_sweep_measures_for_real_on_the_cpu():
    """The real seam: every candidate's query runs and is timed (seconds > 0)."""
    results = tuning.sweep(N, 64, block_size=128, repeats=1, device="cpu")
    assert [c for c, _ in results] == tuning.candidate_configs(N, 128)
    assert all(t > 0 for _, t in results)


# --- persistent cache lifecycle ---------------------------------------------


def test_tuned_policy_sweeps_once_then_hits(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    want = tuning.KernelConfig(tuning.TUNE_TILES[0], "resident", 128)
    monkeypatch.setattr(hybrid, "_measure", _fake_measure_preferring(want))
    kw = dict(block_size=128, backend="cpu", n_devices=1, path=p)
    assert tuning.get_config(N_RES, 64, policy="tuned", device="cpu", **kw) == want
    # Persisted under the kernel/ namespace as a JSON dict.
    key = tuning.tuning_key(N_RES, 64, backend="cpu", n_devices=1)
    assert calib_cache.load_entry(key, path=p) == dict(want._asdict())
    # Warm cache: zero timing sweeps.
    monkeypatch.setattr(hybrid, "_measure", _fail_measure)
    assert tuning.get_config(N_RES, 64, policy="tuned", **kw) == want


def test_cached_policy_never_measures(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    monkeypatch.setattr(hybrid, "_measure", _fail_measure)
    kw = dict(block_size=128, backend="cpu", n_devices=1, path=p)
    assert tuning.get_config(N, 64, policy="cached", **kw) == tuning.default_config(128)
    key = tuning.tuning_key(N, 64, backend="cpu", n_devices=1)
    calib_cache.store_entry(key, {"tile": 16, "fetch": "dma", "block_size": 128}, p)
    assert tuning.get_config(N, 64, policy="cached", **kw) == tuning.KernelConfig(16, "dma", 128)


def test_stale_version_and_corrupt_entries_are_misses(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    key = tuning.tuning_key(N, 64, backend="cpu", n_devices=1)
    monkeypatch.setattr(hybrid, "_measure", _fail_measure)
    kw = dict(block_size=128, backend="cpu", n_devices=1, path=p)
    default = tuning.default_config(128)
    p.write_text(
        json.dumps(
            {
                "version": calib_cache.CACHE_VERSION + 1,
                "entries": {key: {"tile": 16, "fetch": "dma", "block_size": 128}},
            }
        )
    )
    assert tuning.get_config(N, 64, policy="cached", **kw) == default
    p.write_text("definitely{not json")
    assert tuning.get_config(N, 64, policy="cached", **kw) == default
    calib_cache.store_entry(key, {"tile": 4, "fetch": "dma", "block_size": 128}, p)
    assert tuning.get_config(N, 64, policy="cached", **kw) == tuning.KernelConfig(4, "dma", 128)
    calib_cache.store_entry(key, {"tile": "eight"}, p)
    assert tuning.get_config(N, 64, policy="cached", **kw) == default


def test_threshold_and_kernel_entries_share_one_file(tmp_path):
    p = tmp_path / "cal.json"
    tkey = calib_cache.cache_key(1024, 128, backend="cpu", n_devices=1)
    kkey = tuning.tuning_key(1024, 64, backend="cpu", n_devices=1)
    calib_cache.store(tkey, 77, path=p)
    calib_cache.store_entry(kkey, {"tile": 8, "fetch": "dma", "block_size": 128}, p)
    assert calib_cache.load(tkey, path=p) == 77
    assert tuning.config_from_entry(calib_cache.load_entry(kkey, path=p)) == (
        tuning.KernelConfig(8, "dma", 128)
    )


# --- determinism: untuned paths are machine-state independent ----------------


def test_default_policy_never_touches_the_cache(monkeypatch):
    monkeypatch.setattr(hybrid, "_measure", _fail_measure)
    monkeypatch.setattr(calib_cache, "load_entry", lambda *a, **k: pytest.fail("cache read"))
    assert tuning.get_config(N, 64, policy=None) == tuning.default_config(128)
    assert tuning.get_config(N, 64, policy=None, block_size=256) == tuning.default_config(256)


def test_untuned_build_bit_identical_before_and_after_cache_write(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    monkeypatch.setenv(calib_cache.ENV_VAR, str(p))
    rng = np.random.default_rng(21)
    n = 2048
    x = rng.integers(0, 4, n).astype(np.float32)
    a = rng.integers(0, n, 64)
    b = rng.integers(0, n, 64)
    l, r = np.minimum(a, b), np.maximum(a, b)

    def run():
        state, cfg = build_mod.build("fused", x, device="cpu", block_size=128)
        i, v = ops.query(state, l, r, config=cfg)
        return cfg, to_np(i), to_np(v)

    cfg1, i1, v1 = run()
    calib_cache.store_entry(
        tuning.tuning_key(n, backend="cpu", n_devices=1),
        {"tile": 16, "fetch": "dma", "block_size": 256},
        p,
    )
    cfg2, i2, v2 = run()
    assert cfg1 == cfg2 == tuning.default_config(128)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(v1, v2)


def test_fused_plan_carries_resolved_config():
    plan = build_mod.plan_for("fused", 4096, device="cpu", kernel_config=(4, "dma", 128))
    assert plan.meta["kernel_config"] == tuning.KernelConfig(4, "dma", 128)
    assert plan.meta["block_size"] == 128
    plan2 = build_mod.plan_for("fused", 4096, device="cpu", kernel_config=(8, "auto", 256))
    assert plan2.meta["block_size"] == 256


def test_pinned_dma_variant_survives_serving_policy(tmp_path, monkeypatch):
    monkeypatch.setenv(calib_cache.ENV_VAR, str(tmp_path / "cal.json"))
    plan = registry.plan_for_serving("fused128_dma", 4096, "cpu", kernel_config="cached")
    assert plan.meta["kernel_config"] == tuning.KernelConfig(8, "dma", 128)
    plan2 = registry.plan_for_serving("fused128", 4096, "cpu", kernel_config="cached")
    assert plan2.meta["kernel_config"] == tuning.default_config(128)


def test_hybrid_kernel_config_resolved_only_with_kernels(monkeypatch):
    monkeypatch.setattr(hybrid, "_measure", _fail_measure)
    plan = build_mod.plan_for("hybrid", 4096, device="cpu", use_kernels=False, kernel_config=None)
    assert plan.meta["kernel_config"] is None
    plan2 = build_mod.plan_for("hybrid", 4096, device="cpu", use_kernels=True, kernel_config=None)
    assert plan2.meta["kernel_config"] == tuning.default_config(128)


def test_hybrid_tuned_build_sweeps_on_its_device_and_keys_its_backend(tmp_path, monkeypatch):
    """kernel_config="tuned" on a kernel hybrid sweeps within its block size
    on the plan's device and stores under that device's backend."""
    monkeypatch.setenv(calib_cache.ENV_VAR, str(tmp_path / "cal.json"))
    want = tuning.KernelConfig(tuning.TUNE_TILES[-1], "dma", 128)
    seen = []

    def fake(kind, fn, lj, rj, repeats):
        seen.append(lj.device.type)
        return _fake_measure_preferring(want)(kind, fn, lj, rj, repeats)

    monkeypatch.setattr(hybrid, "_measure", fake)
    plan = build_mod.plan_for("hybrid", N, device="cpu", use_kernels=True, kernel_config="tuned")
    assert plan.meta["kernel_config"] == want and set(seen) == {"cpu"}
    key = tuning.tuning_key(N, backend="cpu", n_devices=1)
    assert calib_cache.load_entry(key) == dict(want._asdict())


# --- parity with the reference -------------------------------------------------


def _recording(want, seen):
    def fake(kind, fn, lj, rj, repeats):
        seen.append(kind)
        return _fake_measure_preferring(want)(kind, fn, lj, rj, repeats)

    return fake


@pytest.mark.parametrize("want", [(4, "resident", 128), (16, "dma", 128), (8, "dma", 256)])
def test_autotune_matches_reference_on_the_same_candidates(want, monkeypatch):
    """Explicit (reference-valued) candidates, the same fake timings: the same
    winner from both packages, and the same kinds timed in the same order."""
    cands = [
        tuning.KernelConfig(t, f, bs)
        for bs in (128, 256)
        for f in ("resident", "dma")
        for t in (4, 8, 16)
    ]
    jw, pw = jax_tuning.KernelConfig(*want), tuning.KernelConfig(*want)
    jseen, pseen = [], []
    monkeypatch.setattr(jax_hybrid, "_measure", _recording(jw, jseen))
    monkeypatch.setattr(hybrid, "_measure", _recording(pw, pseen))
    jcands = [jax_tuning.KernelConfig(*c) for c in cands]
    got_ref = jax_tuning.autotune(N, 64, candidates=jcands, interpret=True)
    got = tuning.autotune(N, 64, candidates=cands, device="cpu")
    assert tuple(got) == tuple(got_ref) and got == pw
    assert pseen == jseen and len(pseen) == len(cands)


def test_layout_sweep_matches_reference(monkeypatch):
    """layouts=: packed32 is skipped on the float sweep data by both, and the
    quantized candidates are timed under the same kinds."""
    jseen, pseen = [], []
    monkeypatch.setattr(jax_hybrid, "_measure", lambda kind, *a: jseen.append(kind) or 1.0)
    monkeypatch.setattr(hybrid, "_measure", lambda kind, *a: pseen.append(kind) or 1.0)
    cands = [
        (4, "resident", 128, "unpacked"),
        (4, "resident", 128, "packed32"),
        (8, "resident", 128, "quantized"),
        (8, "dma", 128, "unpacked"),
    ]
    jax_tuning.sweep(N, 64, candidates=[jax_tuning.KernelConfig(*c) for c in cands], interpret=True)
    tuning.sweep(N, 64, candidates=[tuning.KernelConfig(*c) for c in cands], device="cpu")
    assert pseen == jseen and len(pseen) == 3
    assert not any("packed32" in k for k in pseen)


def test_tuned_cache_file_matches_reference_bytes(tmp_path, monkeypatch):
    want = (16, "dma", 128)
    monkeypatch.setattr(jax_hybrid, "_measure", _fake_measure_preferring(jax_tuning.KernelConfig(*want)))
    monkeypatch.setattr(hybrid, "_measure", _fake_measure_preferring(tuning.KernelConfig(*want)))
    cands = [(t, f, 128) for f in ("resident", "dma") for t in (4, 8, 16)]
    kw = dict(block_size=128, backend="cpu", n_devices=1)
    jp, pp = tmp_path / "ref.json", tmp_path / "port.json"
    jax_cache.store(jax_cache.cache_key(N, 128, backend="cpu", n_devices=1), 33, path=jp)
    calib_cache.store(calib_cache.cache_key(N, 128, backend="cpu", n_devices=1), 33, path=pp)
    got_ref = jax_tuning.get_config(
        N, 64, policy="tuned", path=jp, interpret=True,
        candidates=[jax_tuning.KernelConfig(*c) for c in cands], **kw,
    )
    got = tuning.get_config(
        N, 64, policy="tuned", path=pp, device="cpu",
        candidates=[tuning.KernelConfig(*c) for c in cands], **kw,
    )
    assert tuple(got) == tuple(got_ref)
    assert pp.read_bytes() == jp.read_bytes()
    assert tuning.tuning_key(N, 64, backend="cpu", n_devices=1) == jax_tuning.tuning_key(
        N, 64, backend="cpu", n_devices=1
    )
