"""The benchmark's harness on the CPU: its files resolve by name, its names
keep the character rules, the query generator routes as the paper's
regimes do, a whole run at a small size is correct, and every fault planted
under the timed path, and the lower-precision control, come out as not
correct. Besides the cells of ``BENCHMARK.json``, whole runs take cells built
here (``LOCAL``): an engine with no threshold, int32 values, and a cell that
reports every reader of the file. A reader that a run can leave unread says
why in its own file (``spec.needs``); the tests hold it to that. The card's
own run is the ``cuda`` test at the end."""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness, queries, reference, roofline, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
FULL = spec.cell(CELLS[0], BENCH).config
N_FULL = int(FULL["n"])
# Whole runs drive each cell under every traffic mix of the folder, also a
# mix that no cell of BENCHMARK.json names yet.
TRAFFICS = sorted(p.stem for p in (spec.BENCH / "traffic").glob("*.json"))


def _local(name: str, config: dict, every_reader: bool = False):
    """A cell built here and in no entry of ``BENCHMARK.json``. It reports
    the metrics that a new cell of the file would, or with ``every_reader``
    every metric of the file."""
    e2e = [m for m in BENCH["end_to_end"] if every_reader or "workloads" not in m]
    per_layer = [m for m in BENCH["per_layer"] if every_reader or "workloads" not in m]
    return spec.Cell(name, 1, config, spec.cell(CELLS[0], BENCH).traffic, e2e, per_layer)


LOCAL = {
    c.name: c
    for c in (
        # An engine with no threshold: the paper's GPU baseline.
        _local("lca_f32.local", dict(FULL, engine="lca", expect={})),
        # int32 values, from the generator ``_local_data`` gives this name.
        _local("hybrid_i32.local", dict(FULL, dtype="int32", data="uniform_i32"), every_reader=True),
        # Every reader, those only a card reads among them, over packed64.
        _local(
            "packed_hybrid_f32.local",
            dict(FULL, engine="packed_hybrid", expect=dict(FULL["expect"], layout="packed64")),
            every_reader=True,
        ),
    )
}
RUNS = [(c, t) for c in CELLS + list(LOCAL) for t in TRAFFICS]


def small_cell(name: str, traffic: str | None = None):
    """Cell ``name`` (under the mix ``traffic``, if given) at a size a test
    run holds: n = 2^12, batches of 1024, and where the configuration states
    a threshold, sqrt(n) = 64."""
    c = LOCAL[name] if name in LOCAL else spec.cell(name, BENCH)
    cfg = dict(c.config, n=2**12, batch=1024)
    if "threshold" in cfg["expect"]:
        cfg["expect"] = dict(cfg["expect"], threshold=64)
    mix = c.traffic if traffic is None else json.loads((spec.BENCH / "traffic" / f"{traffic}.json").read_text())
    return c._replace(config=cfg, traffic=dict(mix, pool=4, check_batches=3, trace_batches=3))


def _uniform_i32(config, seed, device):
    """int32 values drawn from the seed over the whole int32 range."""
    gen = torch.Generator(device=device).manual_seed(spec.seed_for(seed, "data"))
    return torch.randint(-(2**31), 2**31, (int(config["n"]),), generator=gen, device=device).to(torch.int32)


LOCAL_DATA = {"uniform_i32": _uniform_i32}


@pytest.fixture(autouse=True)
def _local_data(monkeypatch):
    """The local cells' data generators, found by name as a file's would be."""
    find = spec.data_generator
    monkeypatch.setattr(spec, "data_generator", lambda name: LOCAL_DATA.get(name) or find(name))


def engine_of(name: str) -> str:
    return small_cell(name).config["engine"]


def run_small(name, traffic=None, engine=None, trace=False, seed=2**31 + 17):
    c = small_cell(name, traffic)
    return harness.run_cell(c, seed, 0.05, trace, "cpu", engine=engine, log=lambda m: None)


# --- the catalogue ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(p.stem for p in (spec.BENCH / "metrics").glob("*.py")))
def test_reader_states_what_it_needs_with_a_reason(name):
    assert callable(spec.reader(name))
    for condition, why in spec.needs(name).items():
        assert condition in spec.CONDITIONS
        assert isinstance(why, str) and 1 <= len(why) <= 200 and "\n" not in why


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve_by_name(name):
    c = spec.cell(name, BENCH)
    assert c.chips == 1
    assert (spec.BENCH / "traffic" / f"{next(w for w in BENCH['workloads'] if w['name'] == name)['traffic']}.json").is_file()
    assert callable(spec.data_generator(c.config["data"]))
    assert callable(spec.loop(c.traffic["loop"]).drive)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))
    for m in c.per_layer:
        assert m["moves"] in names


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert (spec.ROOT / p).is_dir() and not p.startswith("/") and ".." not in p.split("/")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        config = json.loads((spec.ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        # Each cut of scale is stated: the source's figure and the reason.
        for key in c["reduced"]:
            assert config[key] != config["source_values"][key] and config["why_reduced"][key]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_keep_the_character_rules():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert spec.NAME_RE.fullmatch(name), name
    for kind in (METRICS, BENCH["workloads"], BENCH["configs"]):
        assert len({e["name"] for e in kind}) == len(kind)
    for m in METRICS:
        assert spec.UNIT_RE.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    texts += BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_files_under_paths_are_named_from_name_characters():
    for path in spec.BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert all(spec.NAME_RE.fullmatch(part) for part in rel.split("/")), rel


def test_seed_for_takes_any_whole_number():
    seeds = [0, 1, 2**31 + 5, 2**64 + 3, -7]
    got = [spec.seed_for(s, "queries") for s in seeds]
    assert len(set(got)) == len(seeds) and all(0 <= g < 2**63 for g in got)
    assert spec.seed_for(5, "queries") != spec.seed_for(5, "data")


# --- the frozen query generator -------------------------------------------


def _routing(traffic_name: str, size: int):
    traffic = json.loads((spec.BENCH / "traffic" / f"{traffic_name}.json").read_text())
    gen = torch.Generator().manual_seed(3)
    l, r = queries.batch(traffic["length"], N_FULL, size, gen, "cpu")
    assert l.dtype == r.dtype == torch.int32
    assert int(l.min()) >= 0 and int(r.max()) < N_FULL and bool((l <= r).all())
    assert math.isqrt(N_FULL) == FULL["expect"]["threshold"]
    return int(((r - l + 1) <= FULL["expect"]["threshold"]).sum()), size


def test_small_regime_routes_every_query_short():
    short, size = _routing("small_b22", 2**20)
    assert short == size


def test_large_regime_routes_about_sqrt_n_share_short():
    short, size = _routing("large_b22", 2**22)
    expected = size * FULL["expect"]["threshold"] / N_FULL  # about 419 of 2^22
    assert abs(short - expected) < 5 * math.sqrt(expected)


def test_small_regime_median_is_n_to_the_0_3():
    spec_ = {"dist": "lognormal", "median_exponent": 0.3, "sigma": 0.3}
    length = queries.lengths(spec_, N_FULL, 2**16, torch.Generator().manual_seed(1), "cpu")
    assert abs(float(length.double().median()) / N_FULL**0.3 - 1) < 0.02


def test_pool_is_the_same_from_the_same_seed_and_differs_across_seeds():
    traffic = {"length": {"dist": "uniform", "low": 1, "high": "n"}, "pool": 3}
    a = queries.pool(traffic, 1000, 64, 2**31 + 9, "cpu")
    b = queries.pool(traffic, 1000, 64, 2**31 + 9, "cpu")
    c = queries.pool(traffic, 1000, 64, 2**31 + 10, "cpu")
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[0][0], a[1][0])  # the pool's batches are distinct


# --- the 16-byte work count ------------------------------------------------


@pytest.mark.parametrize("block_size", [128, 256, 512])
@pytest.mark.parametrize("packed", [None, "packed32"])
def test_work_count_does_not_depend_on_block_size_or_layout(block_size, packed):
    from repro_torch.core import build as build_mod
    from repro_torch.core import hybrid

    x = torch.from_numpy(np.random.default_rng(0).integers(0, 50, 4096).astype(np.int32))
    state = build_mod.build("hybrid", x, device="cpu", block_size=block_size, packed=packed)
    traffic = {"length": {"dist": "uniform", "low": 1, "high": "n"}, "pool": 1}
    (l, r), = queries.pool(traffic, 4096, 2048, 11, "cpu")
    splits = []
    with hybrid.record_splits(lambda s, lo: splits.append((s, lo))):
        hybrid.query(state, l, r)
    (n_short, n_long), = splits
    assert n_short > 0 and n_long > 0
    assert roofline.query_bytes(n_short) + roofline.query_bytes(n_long) == 16 * 2048


def test_roofline_share_has_nothing_to_read_without_work_or_time():
    assert roofline.roofline_pct(0, 1.0) is None
    assert roofline.roofline_pct(10, 0.0) is None
    assert roofline.roofline_pct(3.35e12 / 16, 1.0) == pytest.approx(100.0)


def test_busy_time_is_a_union_and_gaps_are_named_by_the_host():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 15.0), ("copy", 30.0, 40.0)]
    host = [("bench.query", 0.0, 100.0), ("numpy work", 15.0, 30.0)]
    assert roofline.busy_seconds(dev, 0.0, 100.0) == pytest.approx(25e-6)
    assert roofline.busy_seconds(dev, 8.0, 35.0) == pytest.approx(12e-6)
    gaps = dict(roofline.idle_gaps(dev, host, 0.0, 100.0))
    assert gaps == pytest.approx({"numpy work": 15e-6, "bench.query": 60e-6})


# --- whole runs on the CPU -------------------------------------------------


def _query_kernel_launches() -> int:
    """The port's CUDA query kernels launched so far (plain calls do not count)."""
    from repro_torch.kernels.fused_query import fused_query, fused_query_packed

    return fused_query.launches + fused_query_packed.launches


class _Routed(harness.ProgramEngine):
    """The program as it is, noting how dispatch routed each batch of the
    traced slice and whether a query kernel ran there: what the readers'
    ``NEEDS`` are held against."""

    def __init__(self, name):
        super().__init__(name)
        self.splits = []
        self.kernel_launches = 0
        record = self.record_splits

        @contextlib.contextmanager
        def noting(cb):
            def both(n_short, n_long):
                self.splits.append((n_short, n_long))
                cb(n_short, n_long)

            before = _query_kernel_launches()
            with record(both):
                yield
            self.kernel_launches += _query_kernel_launches() - before

        self.record_splits = noting

    def met(self, card: bool) -> set:
        """The conditions of ``spec.CONDITIONS`` that the run met."""
        got = {
            "card": card,
            "short": any(s for s, _ in self.splits),
            "long": any(lo for _, lo in self.splits),
            "mixed": any(s and lo for s, lo in self.splits),
            "kernel": self.kernel_launches > 0,
        }
        return {k for k, v in got.items() if v}


def readable(metrics, met: set) -> set:
    """The names of ``metrics`` whose readers need nothing outside ``met``."""
    return {m["name"] for m in metrics if set(spec.needs(m["name"])) <= met}


@pytest.mark.parametrize("name,traffic", RUNS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_and_reports_the_cell_metrics(name, traffic, trace):
    engine = _Routed(engine_of(name))
    res = run_small(name, traffic, engine=engine, trace=trace)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"] == {"idx_wrong": {"value": 0, "limit": 0}, "val_wrong": {"value": 0, "limit": 0}}
    c = small_cell(name, traffic)
    # No device on the CPU: what a reader declares it needs and the run
    # lacked is left out, never 0; every other metric reads above 0.
    want = readable(c.per_layer if trace else c.end_to_end, engine.met(card=False))
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize(
    "name,traffic,met",
    [
        (CELLS[0], "large_b22", {"short", "long", "mixed"}),
        (CELLS[0], "small_b22", {"short"}),
        ("lca_f32.local", "large_b22", set()),
    ],
)
def test_traced_routing_is_what_the_needs_are_held_against(name, traffic, met):
    engine = _Routed(engine_of(name))
    run_small(name, traffic, engine=engine, trace=True)
    assert engine.met(card=False) == met


class _Faulty(harness.ProgramEngine):
    """The program with one fault planted where its answers are produced."""

    def __init__(self, name, fault):
        super().__init__(name)
        self.fault = fault
        self.last = None
        self.x = None

    def build(self, x, device):
        self.x = x  # the array the harness made, whatever the engine's state
        return super().build(x, device)

    def query(self, state, l, r):
        if self.fault == "half":  # half of the batch answered, and sent twice
            h = l.shape[0] // 2
            idx, val = super().query(state, l[:h], r[:h])
            return torch.cat([idx, idx]), torch.cat([val, val])
        idx, val = super().query(state, l, r)
        if self.fault == "stale":  # the previous call's answers
            out, self.last = (self.last or (idx, val)), (idx, val)
            return out
        if self.fault == "altered":  # one index off by one
            idx = idx.clone()
            idx[7] += 1 if int(idx[7]) == 0 else -1
            return idx, val
        if self.fault == "rightmost":  # ties broken to the right
            x = self.x.cpu().numpy()
            ln, rn = l.cpu().numpy(), r.cpu().numpy()
            right = [int(a + np.flatnonzero(x[a : b + 1] == x[a : b + 1].min())[-1]) for a, b in zip(ln, rn)]
            idx = torch.tensor(right, dtype=torch.int32, device=self.x.device)
            return idx, self.x[idx]
        raise ValueError(self.fault)


def _tied(config, seed, device):
    """Eight values in the configuration's dtype, so that every range of more
    than a few cells ties: eighths for float32, 0 to 7 for int32."""
    gen = torch.Generator(device=device).manual_seed(spec.seed_for(seed, "data"))
    n = int(config["n"])
    v = torch.randint(0, 8, (n,), generator=gen, device=device)
    return v.to(torch.int32) if config["dtype"] == "int32" else v.to(torch.float32) / 8


FAULTS = [(c, t, f) for c, t in RUNS for f in ("half", "stale", "altered", "rightmost")]


@pytest.mark.parametrize("name,traffic,fault", FAULTS)
def test_fault_under_the_timed_path_is_not_correct(name, traffic, fault, monkeypatch):
    if fault == "rightmost":  # the float32 draws tie at full size (2^24 values in 10^8 cells)
        monkeypatch.setattr(spec, "data_generator", lambda name: _tied)
    res = run_small(name, traffic, engine=_Faulty(engine_of(name), fault))
    assert res["correct"] is False
    assert res["checks"]["idx_wrong"]["value"] > 0 or res["checks"]["val_wrong"]["value"] > 0


@pytest.mark.parametrize("name,traffic", RUNS)
def test_stale_answers_are_caught_in_a_one_batch_window(name, traffic):
    engine = _Faulty(engine_of(name), "stale")
    c = small_cell(name, traffic)
    res = harness.run_cell(c, 2**31 + 19, 0.0, False, "cpu", engine=engine, log=lambda m: None)
    assert res["attempted"] == 1024  # the window held one batch
    assert res["correct"] is False


@pytest.mark.parametrize("name,traffic", RUNS)
def test_sound_run_over_tied_values_is_correct(name, traffic, monkeypatch):
    monkeypatch.setattr(spec, "data_generator", lambda name: _tied)
    res = run_small(name, traffic)
    assert res["correct"] is True and res["failed"] == 0


@pytest.mark.parametrize("name,traffic", RUNS)
def test_lower_precision_control_is_not_correct(name, traffic):
    res = run_small(name, traffic, engine=reference.ControlEngine())
    assert res["correct"] is False
    assert res["checks"]["val_wrong"]["value"] > 0


# --- the command ------------------------------------------------------------


def _run_cli(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, also where the tests run beside one
    cmd = [sys.executable, "bench/run.py", "--workload", CELLS[0], "--seed", "5", "--seconds", "1", *extra]
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    from bench import run

    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core.hybrid", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax", "repro"]


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    out = _run_cli(spec.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CPU fallback" in out.stderr


def test_command_with_only_the_benchmark_files_exits_nonzero(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


_IMPORTS = """
import sys
sys.path[0:0] = [{root!r}, {src!r}]

def top():
    return " ".join(sorted({{m.split(".")[0] for m in sys.modules}}))

import bench.reference, bench.queries, bench.roofline
print(top())
from bench import run, harness, spec
harness.ProgramEngine("hybrid")
bench_ = spec.load_benchmark()
[spec.reader(m["name"]) for m in bench_["per_layer"] + bench_["end_to_end"]]
[spec.data_generator(c["data"]) for c in (spec.cell(w["name"]).config for w in bench_["workloads"])]
spec.loop("closed")
print(top())
"""


def test_imports_hold_neither_jax_nor_the_jax_package_and_the_reference_no_program():
    code = _IMPORTS.format(root=str(spec.ROOT), src=str(spec.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    reference_top, harness_top = (set(line.split()) for line in out.stdout.splitlines()[-2:])
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    assert not reference_top & (forbidden | {"repro_torch"})
    assert "repro_torch" in harness_top and not harness_top & forbidden


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels of the short path run only there")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name,traffic", RUNS)
def test_small_run_on_the_card_is_correct(cuda_device, name, traffic):
    c = small_cell(name, traffic)
    engine = _Routed(c.config["engine"])
    res = harness.run_cell(c, 2**31 + 3, 0.2, True, cuda_device, engine=engine, log=lambda m: None)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    # Each reader that has all it needs reads; one that lacks something may
    # still read what earlier runs of this process left in the program's
    # registry, which a run of the benchmark, a process of its own, never sees.
    want = readable(c.per_layer, engine.met(card=True))
    assert want <= set(res["metrics"])
    assert all(res["metrics"][m]["value"] >= 0 for m in want)
