"""Spans and counters of ``core.hybrid.dispatch_by_length`` on the CPU.

Under ``torch.profiler`` a batch shows as one ``dispatch`` host event over
its phases (``dispatch.bounds``, ``dispatch.partition``, one
``dispatch.launch`` per path, ``dispatch.scatter`` for mixed batches); with
no profiler and the disabled tracer the spans cost no allocation; answers
do not depend on tracing; ``dispatch_batches_total`` counts every call,
``dispatch_launched_queries_total`` each launch's padded length, and a CPU
device copies nothing. Small n: the file runs in a few seconds.
"""

import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import hybrid, registry
from repro_torch.obs import metrics, trace

N = 4096
PHASES = ("dispatch.bounds", "dispatch.partition", "dispatch.launch", "dispatch.scatter")


@pytest.fixture(scope="module")
def state():
    x = np.random.default_rng(0).random(N, dtype=np.float32)
    return registry.get("hybrid").build(x, device="cpu")  # threshold sqrt(N) = 64


@pytest.fixture
def reg(monkeypatch):
    fresh = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", fresh)
    return fresh


def _batch(kind: str, b: int = 300, seed: int = 1):
    """``b`` int32 queries: all short (``short``), all long (``long``) or
    about half of each (``mixed``), against the threshold 64."""
    rng = np.random.default_rng(seed)
    lo, hi = {"short": (1, 64), "long": (65, N), "mixed": (1, 129)}[kind]
    length = rng.integers(lo, hi + 1, b)
    l = (rng.random(b) * (N - length + 1)).astype(np.int64)
    return torch.from_numpy(l.astype(np.int32)), torch.from_numpy((l + length - 1).astype(np.int32))


def _query(state, l, r):
    return registry.get("hybrid").query(state, l, r)


def _host_events(prof, prefix="dispatch"):
    return [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.name.startswith(prefix) and not e.is_async
    ]


@pytest.mark.parametrize("kind,launches,scatters", [("mixed", 2, 1), ("short", 1, 0), ("long", 1, 0)])
def test_profiler_sees_one_dispatch_over_its_phases(state, kind, launches, scatters):
    l, r = _batch(kind)
    _query(state, l, r)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _query(state, l, r)
    ev = _host_events(prof)
    names = [n for n, _, _ in ev]
    assert names.count("dispatch") == 1
    want = {"dispatch.bounds": 1, "dispatch.partition": 1, "dispatch.launch": launches, "dispatch.scatter": scatters}
    assert {p: names.count(p) for p in PHASES} == want
    (_, lo, hi), = [e for e in ev if e[0] == "dispatch"]
    phases = sorted((s, t) for n, s, t in ev if n in PHASES)
    assert all(lo <= s <= t <= hi for s, t in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:])), phases  # none overlaps another


def test_build_stages_reach_the_profiler():
    x = np.random.default_rng(2).random(N, dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        registry.get("hybrid").build(x, device="cpu")
    assert {"shard_layout", "local_build", "finalize"} <= {e.name for e in prof.events()}


def test_disabled_spans_allocate_nothing_and_record_nothing(state):
    off = trace.Tracer(enabled=False)
    prev = trace.set_tracer(off)
    try:
        l, r = _batch("mixed")
        _query(state, l, r)  # binds the profiler flag read
        assert not trace.tracing()
        tracemalloc.start()
        try:
            _query(state, l, r)
            snap = tracemalloc.take_snapshot()
        finally:
            tracemalloc.stop()
    finally:
        trace.set_tracer(prev)
    mine = snap.filter_traces([tracemalloc.Filter(True, trace.__file__)])
    assert mine.statistics("lineno") == []
    assert off.spans() == []


def test_answers_do_not_depend_on_tracing(state):
    l, r = _batch("mixed", b=1000, seed=3)
    want = _query(state, l, r)
    on = trace.Tracer()
    prev = trace.set_tracer(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert trace.tracing()
            got = _query(state, l, r)
    finally:
        trace.set_tracer(prev)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    spans = on.spans()
    (root,) = [s for s in spans if s.name == "dispatch"]
    n_short = int(((r - l + 1) <= state.threshold).sum())
    assert root.attrs == {"short": n_short, "long": 1000 - n_short}
    kids = sorted(s.name for s in spans if s.parent_id == root.span_id)
    assert kids == sorted(["dispatch.bounds", "dispatch.partition", "dispatch.launch", "dispatch.launch", "dispatch.scatter"])


def test_cpu_dispatch_counts_batches_and_copies_nothing(state, reg):
    for kind in ("mixed", "short", "long"):
        _query(state, *_batch(kind))
    _query(state, np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert reg.counter_total("dispatch_batches_total") == 4
    assert reg.counter_total("dispatch_copy_bytes_total") == 0
    assert reg.histograms() == []  # no device time on the CPU
    # Each launch's length, its (0, 0) pads included; no kernel ran.
    l, r = _batch("mixed")
    n_short = int(((r - l + 1) <= state.threshold).sum())
    launched = {"short": hybrid._pow2(n_short) + 512, "long": hybrid._pow2(300 - n_short) + 512}
    for path, want in launched.items():
        assert reg.counter_total("dispatch_launched_queries_total", path=path) == want
    assert reg.counter_total("query_kernel_queries_total") == 0
