"""The port's calibration: ``hybrid.calibrate`` and the persistent threshold cache.

The 10 single-host cases of ``tests/test_calibration.py`` on the port
(degenerate crossover paths through a fake ``hybrid._measure``; cache hit /
miss / stale / corrupt in ``tmp_path`` files; the build policies), then
parity with the reference: the same fake measurements give the same
threshold from both packages' ``calibrate``, and the same stores give
byte-identical cache files. ``calibrate(mesh=...)`` is held here on a
``(2, 4)`` CPU mesh and against the reference on a one-device mesh; the
mesh cases of ``tests/test_calibration.py`` are in
``tests/test_torch_sharded_hybrid.py``.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import calib_cache as jax_cache
from repro.core import hybrid as jax_hybrid
from repro_torch.core import calib_cache, hybrid
from repro_torch.launch import serve


def _lengths(n):
    return np.unique(np.geomspace(1, n, num=8).astype(np.int64).clip(1, n))


def _crossover_at(limit):
    """A fake _measure: long overtakes short above length ``limit``."""

    def fake(kind, fn, lj, rj, repeats):
        length = int(np.asarray(rj)[0] - np.asarray(lj)[0] + 1)
        if kind == "short":
            return 1.0
        return 2.0 if length <= limit else 0.5

    return fake


# --- hybrid.calibrate degenerate paths ------------------------------------


def test_calibrate_returns_n_when_short_always_wins(monkeypatch):
    monkeypatch.setattr(hybrid, "_measure", lambda kind, *a, **k: 0.0 if kind == "short" else 1.0)
    assert hybrid.calibrate(256, batch=8, use_kernels=False, repeats=1, device="cpu") == 256


def test_calibrate_returns_zero_when_long_wins_at_length_one(monkeypatch):
    monkeypatch.setattr(hybrid, "_measure", lambda kind, *a, **k: 1.0 if kind == "short" else 0.0)
    assert hybrid.calibrate(256, batch=8, use_kernels=False, repeats=1, device="cpu") == 0


def test_calibrate_reports_interior_crossover(monkeypatch):
    """Long overtakes short above length 16: the last short win is returned."""
    monkeypatch.setattr(hybrid, "_measure", _crossover_at(16))
    thr = hybrid.calibrate(256, batch=8, use_kernels=False, repeats=1, device="cpu")
    lengths = _lengths(256)
    assert thr == int(lengths[lengths <= 16].max())


# --- threshold cache round-trip -------------------------------------------


def test_cache_miss_then_hit_then_other_key_miss(tmp_path):
    p = tmp_path / "cal.json"
    key = calib_cache.cache_key(1024, 128, backend="cpu", n_devices=1)
    assert calib_cache.load(key, path=p) is None
    calib_cache.store(key, 77, path=p)
    assert calib_cache.load(key, path=p) == 77
    other = calib_cache.cache_key(2048, 128, backend="cpu", n_devices=1)
    assert calib_cache.load(other, path=p) is None
    dev8 = calib_cache.cache_key(1024, 128, backend="cpu", n_devices=8)
    assert dev8 != key
    assert calib_cache.load(dev8, path=p) is None


def test_cache_stale_version_is_a_miss_and_store_drops_it(tmp_path):
    p = tmp_path / "cal.json"
    key = calib_cache.cache_key(512, 128, backend="cpu", n_devices=1)
    stale_key = "n=99/bs=128/backend=cpu/ndev=1"
    p.write_text(json.dumps({"version": calib_cache.CACHE_VERSION + 1, "entries": {stale_key: 5}}))
    assert calib_cache.load(stale_key, path=p) is None
    calib_cache.store(key, 33, path=p)
    assert calib_cache.load(key, path=p) == 33
    assert calib_cache.load(stale_key, path=p) is None
    data = json.loads(p.read_text())
    assert data["version"] == calib_cache.CACHE_VERSION
    assert stale_key not in data["entries"]


def test_cache_corrupt_file_is_a_miss_and_recoverable(tmp_path):
    p = tmp_path / "cal.json"
    p.write_text("definitely{not json")
    key = calib_cache.cache_key(64, 128, backend="cpu", n_devices=1)
    assert calib_cache.load(key, path=p) is None
    calib_cache.store(key, 9, path=p)
    assert calib_cache.load(key, path=p) == 9


def test_cache_key_v2_extends_v1_with_mode_and_mesh():
    v1 = calib_cache.cache_key(1024, 128, backend="cpu", n_devices=8)
    assert v1 == "n=1024/bs=128/backend=cpu/ndev=8"
    v2 = calib_cache.cache_key(1024, 128, backend="cpu", n_devices=8, mode="shard_2d", mesh_shape=(2, 4))
    assert v2 == "n=1024/bs=128/backend=cpu/ndev=8/mode=shard_2d/mesh=2x4"
    other_mode = calib_cache.cache_key(
        1024, 128, backend="cpu", n_devices=8, mode="shard_batch", mesh_shape=(2, 4)
    )
    other_mesh = calib_cache.cache_key(
        1024, 128, backend="cpu", n_devices=8, mode="shard_2d", mesh_shape=(8,)
    )
    assert len({v1, v2, other_mode, other_mesh}) == 4


def test_single_host_builds_keep_reading_v1_entries(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    monkeypatch.setenv(calib_cache.ENV_VAR, str(p))
    calib_cache.store(calib_cache.cache_key(900, 128, backend="cpu"), 61, path=p)
    monkeypatch.setattr(hybrid, "calibrate", lambda *a, **k: pytest.fail("must hit the v1 entry"))
    s = hybrid.build(np.zeros(900, np.float32), 128, threshold="cached", use_kernels=False, device="cpu")
    assert s.threshold == 61


def test_get_threshold_measures_once_then_hits(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    calls = []
    monkeypatch.setattr(hybrid, "calibrate", lambda n, **kw: calls.append(n) or 42)
    kw = dict(backend="cpu", n_devices=1, path=p)
    assert calib_cache.get_threshold(512, 128, **kw) == 42
    assert calib_cache.get_threshold(512, 128, **kw) == 42
    assert calls == [512]


def test_build_calibrated_threshold_reads_cache(tmp_path, monkeypatch):
    p = tmp_path / "cal.json"
    monkeypatch.setenv(calib_cache.ENV_VAR, str(p))
    calib_cache.store(calib_cache.cache_key(1000, 128), 21, path=p)  # live defaults
    monkeypatch.setattr(hybrid, "calibrate", lambda *a, **k: pytest.fail("re-measured despite a cache hit"))
    s = hybrid.build(np.zeros(1000, np.float32), 128, threshold="calibrated", use_kernels=False, device="cpu")
    assert s.threshold == 21


# --- the port's own seams ----------------------------------------------------


def test_calibrated_build_measures_on_its_device_once(tmp_path, monkeypatch):
    """A miss measures through ``calibrate`` on the plan's device (both
    paths, kernel short path included), stores under that backend's key,
    and the next build reads it without measuring."""
    monkeypatch.setenv(calib_cache.ENV_VAR, str(tmp_path / "cal.json"))
    seen = []

    def fake(kind, fn, lj, rj, repeats):
        seen.append((kind, lj.device.type, lj.dtype))
        return _crossover_at(40)(kind, fn, lj, rj, repeats)

    monkeypatch.setattr(hybrid, "_measure", fake)
    s = hybrid.build(np.zeros(1000, np.float32), 128, threshold="calibrated", use_kernels=True, device="cpu")
    lengths = _lengths(1000)
    assert s.threshold == int(lengths[lengths <= 40].max())
    assert {d for _, d, _ in seen} == {"cpu"} and {t for *_, t in seen} == {torch.int32}
    assert calib_cache.load(calib_cache.cache_key(1000, 128, backend="cpu", n_devices=1)) == s.threshold
    monkeypatch.setattr(hybrid, "_measure", lambda *a: pytest.fail("measured on a hit"))
    again = hybrid.build(np.ones(1000, np.float32), 128, threshold="calibrated", device="cpu")
    assert again.threshold == s.threshold


def test_default_policies_touch_no_cache_and_no_file(monkeypatch, tmp_path):
    monkeypatch.setenv(calib_cache.ENV_VAR, str(tmp_path / "never" / "cal.json"))
    boom = lambda *a, **k: pytest.fail("the cache was read or written")
    for name in ("_read", "load", "load_entry", "store", "store_entry"):
        monkeypatch.setattr(calib_cache, name, boom)
    monkeypatch.setattr(hybrid, "_measure", boom)
    s = hybrid.build(np.zeros(1000, np.float32), 128, use_kernels=True, device="cpu")
    assert s.threshold == 32  # round(sqrt(1000))
    assert not (tmp_path / "never").exists()


@pytest.mark.parametrize("mode", ["shard_structure", "shard_batch", "shard_2d"])
def test_calibrate_with_mesh_times_the_sharded_constituents(monkeypatch, mode):
    """The mesh call builds the sharded hybrid on the mesh (threshold 0) and
    times its two sharded paths on the mesh's home device; the same fake
    measurements give the reference's threshold (its one-device mesh)."""
    from repro.launch.mesh import make_mesh as jax_make_mesh
    from repro_torch.launch.mesh import make_mesh

    seen = []

    def fake(kind, fn, lj, rj, repeats):
        length = int((np.asarray(rj) - np.asarray(lj) + 1).max())
        if kind == "long":
            return 1.0
        return 2.0 if length > 16 else 0.5

    def port_fake(kind, fn, lj, rj, repeats):
        seen.append((kind, lj.device.type, lj.dtype))
        return fake(kind, fn, lj, rj, repeats)

    monkeypatch.setattr(hybrid, "_measure", port_fake)
    monkeypatch.setattr(jax_hybrid, "_measure", fake)
    mesh = make_mesh((2, 4), ("data", "model"), devices="cpu")
    thr = hybrid.calibrate(256, batch=8, repeats=1, mesh=mesh, mode=mode)
    assert thr == int(_lengths(256)[_lengths(256) <= 16].max())
    assert {k for k, *_ in seen} == {"short", "long"} and {d for _, d, _ in seen} == {"cpu"}
    assert {t for *_, t in seen} == {torch.int32}
    want = jax_hybrid.calibrate(256, batch=8, repeats=1, mesh=jax_make_mesh((1,), ("shard",)), mode=mode)
    one = hybrid.calibrate(256, batch=8, repeats=1, mesh=make_mesh((1,), ("shard",), devices="cpu"), mode=mode)
    assert want == one == thr


def test_measure_takes_the_median_of_the_repeats():
    calls = []

    def fn(l, r):
        calls.append(1)
        return l, r

    t = hybrid._measure("short", fn, torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), 3)
    assert len(calls) == 4 and t >= 0.0  # one warmup + three timed calls


def test_port_cache_is_its_own_file():
    """The two packages never read each other's measurements: a JAX ``cpu``
    entry and a torch ``cpu`` entry would share a key."""
    assert calib_cache.ENV_VAR == "RMQ_TORCH_CALIB_CACHE" != jax_cache.ENV_VAR
    assert calib_cache.default_path().parent.name == "rtxrmq-torch"


# --- parity with the reference -------------------------------------------------


@pytest.mark.parametrize("layout", [None, "quantized", "packed32"])
@pytest.mark.parametrize("limit", [0, 16, 300])
def test_calibrate_matches_reference_on_the_same_measurements(layout, limit, monkeypatch):
    """Both packages, the same fake timings: the same threshold, and the
    same bounds timed in the same order (both draw them from one seed)."""
    seen = {"ref": [], "port": []}

    def recorder(tag):
        def fake(kind, fn, lj, rj, repeats):
            seen[tag].append((kind, np.asarray(lj).tolist(), np.asarray(rj).tolist()))
            return _crossover_at(limit)(kind, fn, lj, rj, repeats)

        return fake

    monkeypatch.setattr(jax_hybrid, "_measure", recorder("ref"))
    monkeypatch.setattr(hybrid, "_measure", recorder("port"))
    want = jax_hybrid.calibrate(1000, batch=8, use_kernels=False, repeats=1, layout=layout)
    got = hybrid.calibrate(1000, batch=8, use_kernels=False, repeats=1, layout=layout, device="cpu")
    assert got == want
    assert seen["port"] == seen["ref"] and seen["port"]


def test_packed32_calibration_above_2_20(monkeypatch):
    """The reference's packed32 proxy spans [-1000, 1000): with 21 index
    bits it does not fit a 32-bit word, and its calibrate raises. The
    port narrows the span there (ROADMAP.md §3); at n <= 2^20 its proxy is
    the reference's array."""
    n = (1 << 20) + 1
    monkeypatch.setattr(jax_hybrid, "_measure", _crossover_at(100))
    monkeypatch.setattr(hybrid, "_measure", _crossover_at(100))
    with pytest.raises(ValueError, match="packed32 cannot encode"):
        jax_hybrid.calibrate(n, batch=8, use_kernels=False, repeats=1, layout="packed32")
    lengths = _lengths(n)
    got = hybrid.calibrate(n, batch=8, use_kernels=False, repeats=1, layout="packed32", device="cpu")
    assert got == int(lengths[lengths <= 100].max())
    proxy = hybrid._packed32_proxy(np.random.default_rng(0), n)
    assert proxy.dtype == np.int32 and int(proxy.max()) - int(proxy.min()) + 1 <= 1023
    same = hybrid._packed32_proxy(np.random.default_rng(0), 1 << 20)
    np.testing.assert_array_equal(same, np.random.default_rng(0).integers(-1000, 1000, 1 << 20))


def test_threshold_cache_file_matches_reference_bytes(tmp_path, monkeypatch):
    """The same measurements and stores, with a v2 file to migrate: the
    port's file is byte for byte the reference's."""
    monkeypatch.setattr(jax_hybrid, "calibrate", lambda n, **kw: 13)
    monkeypatch.setattr(hybrid, "calibrate", lambda n, **kw: 13)
    v2 = {"version": 2, "entries": {"kernel/n=8/batch=4/backend=cpu/ndev=1": {"tile": 8, "fetch": "dma", "block_size": 128}}}
    files = {}
    for tag, cache in (("ref", jax_cache), ("port", calib_cache)):
        p = tmp_path / f"{tag}.json"
        p.write_text(json.dumps(v2))
        assert cache.get_threshold(256, 128, backend="cpu", n_devices=1, path=p) == 13
        assert cache.get_threshold(256, 128, backend="cpu", n_devices=1, path=p, layout="quantized") == 13
        cache.store(cache.cache_key(512, 256, backend="cuda", n_devices=1), 7, path=p)
        files[tag] = p.read_bytes()
    assert files["port"] == files["ref"]
    assert json.loads(files["port"])["entries"]["kernel/n=8/batch=4/backend=cpu/ndev=1"]["layout"] == "unpacked"


# --- the serve CLI's flags ---------------------------------------------------


def test_serve_calibrate_and_tune_measure_once_then_read_the_cache(tmp_path, monkeypatch, capsys):
    """``--calibrate --tune`` on the CPU: the first serve measures the
    crossover and stores it, the build line names it, every answer is
    verified; the second serve reads the cache and measures nothing. A
    flag the engine does not declare is refused."""
    monkeypatch.setenv(calib_cache.ENV_VAR, str(tmp_path / "cal.json"))
    calls = []
    real = hybrid._measure
    monkeypatch.setattr(hybrid, "_measure", lambda *a: calls.append(a[0]) or real(*a))
    argv = ["--device", "cpu", "--engine", "hybrid", "--calibrate", "--tune", "--n", "65536",
            "--batch", "256", "--batches", "2"]
    serve.main(argv)
    out = capsys.readouterr().out
    thr = calib_cache.load(calib_cache.cache_key(65536, 128, backend="cpu", n_devices=1))
    assert calls and thr is not None
    assert f"threshold {thr}" in out and "verify[64] OK" in out
    monkeypatch.setattr(hybrid, "_measure", lambda *a: pytest.fail("measured on a cache hit"))
    serve.main([*argv, "--mode", "async", "--clients", "2", "--requests", "4", "--req-batch", "16"])
    assert "verify: 8/8 requests bit-identical to the oracle" in capsys.readouterr().out
    for flag, kwarg in (("--calibrate", "threshold"), ("--tune", "kernel_config")):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu", "--engine", "lca", flag, "--n", "1024"])
        assert f"{flag} requires an engine with a '{kwarg}' build kwarg" in capsys.readouterr().err
