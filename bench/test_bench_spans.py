"""The readers of the program's dispatch spans and counters, on synthetic
traced slices and registries: a span's time sums over its repeats, is
clipped to the slice and divided by its batches; a program that records
nothing reads None, never 0."""

from __future__ import annotations

import pytest

from bench import spec
from repro_torch.obs import metrics

PHASES = ["dispatch.bounds_ms", "dispatch.partition_ms", "dispatch.launch_ms", "dispatch.scatter_ms"]


def _ctx(host_events, batches=2, lo=100.0, hi=1100.0):
    return {"slice": {"batches": batches, "host_events": host_events, "lo_us": lo, "hi_us": hi}}


@pytest.fixture
def reg(monkeypatch):
    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", fresh)
    return fresh


@pytest.mark.parametrize("metric", PHASES)
def test_phase_sums_its_spans_per_batch_clipped_to_the_slice(metric):
    span = metric.removesuffix("_ms")
    events = [
        ("dispatch", 50.0, 1050.0),
        (span, 50.0, 300.0),  # starts before the slice: 200 us inside
        (span, 400.0, 700.0),  # 300 us
        (span, 1000.0, 1500.0),  # ends after the slice: 100 us inside
        (span, 1200.0, 1300.0),  # after the slice
        (span + "_other", 400.0, 900.0),  # another name, a prefix alike
        ("aten::copy_", 410.0, 420.0),
    ]
    assert spec.reader(metric)(_ctx(events)) == pytest.approx((200 + 300 + 100) / 1e3 / 2)


@pytest.mark.parametrize("metric", PHASES)
def test_phase_reads_none_with_nothing_to_read(metric):
    read = spec.reader(metric)
    assert read({"slice": None}) is None
    assert read(_ctx([("bench.query", 200.0, 900.0)])) is None  # a program without the span
    assert read(_ctx([(metric.removesuffix("_ms"), 1200.0, 1300.0)])) is None  # only outside
    assert read(_ctx([(metric.removesuffix("_ms"), 200.0, 300.0)], batches=0)) is None


def test_copy_mib_is_bytes_both_ways_per_batch(reg):
    reg.counter("dispatch_batches_total").inc(4)
    reg.counter("dispatch_copy_bytes_total", direction="d2h").inc(4 * 64 * 2**20)
    reg.counter("dispatch_copy_bytes_total", direction="h2d").inc(4 * (64 * 2**20 + 4096))
    assert spec.reader("dispatch.copy_mib")(_ctx([])) == 128.00390625


def test_copy_mib_reads_none_where_nothing_is_copied(reg):
    read = spec.reader("dispatch.copy_mib")
    assert read(_ctx([])) is None  # a program without the counters
    reg.counter("dispatch_batches_total").inc(3)  # on the CPU: batches, no copy
    assert read(_ctx([])) is None


def test_path_device_ms_is_the_mean_per_launch(reg):
    for s in (0.001, 0.002, 0.0015):
        reg.histogram("dispatch_path_device_s", path="long").observe(s)
    reg.histogram("dispatch_path_device_s", path="short").observe(2e-5)
    assert spec.reader("long_path.device_ms")(_ctx([])) == pytest.approx(1.5)
    assert spec.reader("short_path.device_ms")(_ctx([])) == pytest.approx(0.02)


def test_path_device_ms_reads_none_where_the_path_never_launched(reg):
    reg.histogram("dispatch_path_device_s", path="long").observe(0.001)
    assert spec.reader("short_path.device_ms")(_ctx([])) is None
    reg.histogram("dispatch_path_device_s", path="short")  # made, never observed
    assert spec.reader("short_path.device_ms")(_ctx([])) is None
