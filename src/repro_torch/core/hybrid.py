"""Range-adaptive hybrid RMQ dispatcher (the paper's crossover, exploited).

The blocked structure is fastest for *short* ranges; the O(1) sparse table
overtakes it at medium and large ranges. A batch is partitioned on the host
by range length against a threshold: short ranges go to the blocked path
(the fused CUDA kernel ``kernels.ops`` when ``use_kernels``, else the plain
``block_rmq``), long ranges to the sparse table over the raw array, and the
two result sets are scattered back into batch order. Results equal
``block_rmq.query`` bit for bit. With ``packed=`` both tiers hold packed
(value, index) words (``core.packing``); the short path then runs the
``fused_query_packed`` kernel for packed32 and quantized, and the plain
packed query for packed64, which has no kernel. ``calibrate`` measures the
crossover of the two paths on the structure's device (the ``"calibrated"``
threshold policy, cached by ``core.calib_cache``). Port of
``repro/core/hybrid.py``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch._device import as_index, resolve, to_numpy
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import default_registry

from . import block_rmq, packing, sparse_table

__all__ = [
    "HybridRMQ",
    "assemble",
    "build",
    "calibrate",
    "query",
    "dispatch_by_length",
    "record_splits",
    "DEFAULT_THRESHOLD_FRAC",
]

# Threshold when none is given: ranges shorter than sqrt(n) touch only a
# couple of blocks and favor the blocked path.
DEFAULT_THRESHOLD_FRAC = 0.5  # threshold = n ** DEFAULT_THRESHOLD_FRAC

_INT32_MAX = np.iinfo(np.int32).max


class HybridRMQ(NamedTuple):
    """Both constituent structures, routing threshold, path closures."""

    blocked: object  # BlockRMQ | ops.FusedRMQ | PackedBlockRMQ | ops.PackedFusedRMQ
    st: object  # SparseTable | PackedSparseTable over the raw array
    x: torch.Tensor  # raw values (answers value lookups for the long path)
    threshold: int  # range lengths <= threshold go to the blocked path
    use_kernels: bool  # short path: fused CUDA kernel vs plain block_rmq
    short_fn: object  # (l, r) -> (idx, val), structure closed over
    long_fn: object  # (l, r) -> (idx, val)
    spec: object = None  # the PackSpec both tiers were packed with; None unpacked


def build(
    x,
    block_size: int = 128,
    *,
    threshold: int | str | None = None,
    use_kernels: bool | None = None,
    kernel_config=None,
    packed=None,
    device=None,
) -> HybridRMQ:
    """Build both constituent engines on ``device`` (via the ``core.build`` plan).

    ``threshold=None`` -> the sqrt(n) default (never touches machine state);
    ``"cached"`` -> the persistent JSON cache (``calib_cache``) with the
    sqrt(n) fallback, never measuring; ``"calibrated"`` -> the cache,
    measuring via ``calibrate`` only on a miss; an int pins it.
    ``use_kernels=None`` -> the kernels exactly when the structure lives on a
    CUDA device. ``kernel_config`` is the launch-geometry policy of the
    kernel short path (None | "cached" | "tuned" | a
    ``kernels.tuning.KernelConfig``), with the same cache lifecycle as
    thresholds. ``packed`` opts both tiers into packed
    words: None/False -> unpacked, True/"auto" -> packed32 when the data's
    key span fits, else packed64, or an explicit layout name.
    """
    from . import build as build_mod  # deferred: build.py hosts the planner

    return build_mod.build(
        "hybrid",
        x,
        block_size=block_size,
        threshold=threshold,
        use_kernels=use_kernels,
        kernel_config=kernel_config,
        packed=packed,
        device=device,
    )


def assemble(
    blocked, st, x, threshold: int, use_kernels: bool, kernel_config=None, spec=None
) -> HybridRMQ:
    """A ``HybridRMQ`` over built parts: the path closures bound to them.

    ``spec`` is the ``PackSpec`` of packed parts (None for unpacked ones).
    """
    if spec is not None:
        if use_kernels and spec.layout in ("packed32", "quantized"):
            from repro_torch.kernels import ops

            short_fn = lambda l, r: ops.query_packed(blocked, spec, l, r, config=kernel_config)
        else:
            short_fn = lambda l, r: block_rmq.query_packed(blocked, spec, l, r)
        long_fn = lambda l, r: sparse_table.query_packed(st, spec, l, r)
    else:
        if use_kernels:
            from repro_torch.kernels import ops

            short_fn = lambda l, r: ops.query(blocked, l, r, config=kernel_config)
        else:
            short_fn = lambda l, r: block_rmq.query(blocked, l, r)

        def long_fn(l, r):
            idx = sparse_table.query(st, l, r)
            return idx, x[idx]

    return HybridRMQ(
        blocked=blocked,
        st=st,
        x=x,
        threshold=int(threshold),
        use_kernels=bool(use_kernels),
        short_fn=short_fn,
        long_fn=long_fn,
        spec=spec,
    )


# Per-thread sink for regime-split observations: the serving layer wraps each
# engine launch in ``record_splits`` so its stats can report how dispatch
# partitioned every coalesced batch without coupling the engines to the server.
_split_sink = threading.local()


@contextlib.contextmanager
def record_splits(cb):
    """Route this thread's ``dispatch_by_length`` splits to ``cb(n_short, n_long)``."""
    prev = getattr(_split_sink, "cb", None)
    _split_sink.cb = cb
    try:
        yield
    finally:
        _split_sink.cb = prev


def _device_nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` that live off the host: what a copy
    between host and device moves for them (0 on the CPU)."""
    return sum(t.nbytes for t in ts if isinstance(t, torch.Tensor) and t.device.type != "cpu")


def _padded(lm, rm, device):
    """Bounds padded to a power of two with (0, 0) queries, as the reference
    pads to bound its jit cache (the same launch shapes here), on ``device``;
    the count of real queries; and the host arrays (``lm``, ``rm`` and their
    padded copies), for the caller to free once the paths have launched."""
    k = lm.size
    kp = 1 << (k - 1).bit_length() if k > 1 else 1
    lp = np.zeros(kp, np.int32)
    rp = np.zeros(kp, np.int32)
    lp[:k] = lm
    rp[:k] = rm
    return as_index(lp, device), as_index(rp, device), k, (lm, rm, lp, rp)


# Each path's launches timed by CUDA events while tracing, as (path, start,
# end): read once the end event has completed, so no synchronize is added.
_device_times = []
_device_times_lock = threading.Lock()


def _observe_device_times() -> None:
    """Move the completed pairs of ``_device_times`` into the
    ``dispatch_path_device_s{path}`` histogram; keep the rest pending."""
    with _device_times_lock:
        pending = []
        for path, start, end in _device_times:
            if end.query():
                default_registry().histogram("dispatch_path_device_s", path=path).observe(
                    start.elapsed_time(end) / 1e3
                )
            else:
                pending.append((path, start, end))
        _device_times[:] = pending


def dispatch_by_length(l, r, threshold: int, short_fn, long_fn, out_dtype, device):
    """Range-adaptive dispatch core: partition, per-regime launches, scatter-back.

    Host-side partition of the batch by range length against ``threshold``,
    per-regime launches through ``short_fn`` / ``long_fn`` (each
    ``(l, r) -> (idx, val)`` on int32 tensors on ``device``), ordered exact
    scatter-back. Empty batches return empty ``(idx, val)`` without
    launching anything.

    Bounds must be integer arrays inside the int32 index range: every
    constituent computes int32 indices, so an out-of-range bound would wrap
    silently instead of failing loudly.

    Traced as a ``dispatch`` span (attrs ``short``, ``long``: the split)
    over the phases ``dispatch.bounds``, ``dispatch.partition``,
    ``dispatch.launch`` (one per path launched) and, for mixed batches,
    ``dispatch.scatter``. Counted always in ``obs.metrics.default_registry()``:
    ``dispatch_batches_total`` and ``dispatch_copy_bytes_total{direction}``
    (``d2h`` / ``h2d``: the bytes of every copy between host and device).
    While ``obs.trace.tracing()`` on a CUDA device, each launch's device time
    goes to ``dispatch_path_device_s{path}`` (``short`` / ``long``).
    """
    if _device_times:
        _observe_device_times()
    tr = obs_trace.get_tracer()
    reg = default_registry()
    reg.counter("dispatch_batches_total").inc()
    with tr.span("dispatch") as span:
        with tr.span("dispatch.bounds"):
            d2h = _device_nbytes(l, r)
            l = to_numpy(l)
            r = to_numpy(r)
            if not (np.issubdtype(l.dtype, np.integer) and np.issubdtype(r.dtype, np.integer)):
                raise TypeError(f"query bounds must be integer arrays, got {l.dtype} / {r.dtype}")
            l = l.astype(np.int64)
            r = r.astype(np.int64)
            if l.size == 0:  # nothing to do: no phantom padded query, no launch
                return (
                    torch.zeros(0, dtype=torch.int32, device=device),
                    torch.zeros(0, dtype=out_dtype, device=device),
                )
            if int(l.min()) < 0 or int(r.max()) > _INT32_MAX:
                raise ValueError(
                    f"query bounds [{int(l.min())}, {int(r.max())}] outside the engines' "
                    "int32 index range"
                )

        with tr.span("dispatch.partition"):
            short = (r - l + 1) <= threshold
            n_short = int(short.sum())
            n_long = int(l.size - n_short)
            cb = getattr(_split_sink, "cb", None)
            if cb is not None:
                cb(n_short, n_long)
            if tr.enabled:
                span.set_attr("short", n_short)
                span.set_attr("long", n_long)
            if n_short == 0 or n_long == 0:
                # Uniform batches skip the partition/scatter round-trip entirely.
                parts = [("short" if n_short else "long", None, _padded(l, r, device))]
            else:
                idx = np.empty(l.shape, np.int32)
                parts = [
                    (path, mask, _padded(l[mask], r[mask], device))
                    for path, mask in (("short", short), ("long", ~short))
                ]
            h2d = sum(_device_nbytes(lp, rp) for _, _, (lp, rp, _, _) in parts)

        timed = torch.device(device).type == "cuda" and obs_trace.tracing()
        launched = []
        for path, mask, (lp, rp, k, _) in parts:
            with tr.span("dispatch.launch"):
                fn = short_fn if path == "short" else long_fn
                if timed:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    qi, qv = fn(lp, rp)
                    end.record()
                    with _device_times_lock:
                        _device_times.append((path, start, end))
                else:
                    qi, qv = fn(lp, rp)
            launched.append((mask, qi[:k], qv[:k]))

        if len(launched) == 1:
            out = launched[0][1:]
        else:
            # Mixed batch: bring both answer sets to the host (one copy each)
            # and scatter there, then copy the batch's answers up.
            with tr.span("dispatch.scatter"):
                # The sub-batches' host arrays go only now, after the
                # launches: freed before them, glibc hands their pages back
                # to the system and the answers' downloads below fault in
                # fresh ones (the copies down took about twice as long,
                # about 9% of the rate at 2^22; PERF.md §6).
                del parts, _
                val = None
                for mask, qi, qv in launched:
                    d2h += _device_nbytes(qi, qv)
                    qv = to_numpy(qv)
                    if val is None:
                        val = np.empty(l.shape, qv.dtype)
                    idx[mask] = to_numpy(qi)
                    val[mask] = qv
                out = torch.from_numpy(idx).to(device), torch.from_numpy(val).to(device)
                h2d += _device_nbytes(*out)
            if timed:  # the downloads waited for both launches
                _observe_device_times()
    if d2h:
        reg.counter("dispatch_copy_bytes_total", direction="d2h").inc(d2h)
    if h2d:
        reg.counter("dispatch_copy_bytes_total", direction="h2d").inc(h2d)
    return out


def query(s: HybridRMQ, l, r) -> Tuple[torch.Tensor, torch.Tensor]:
    """Range-adaptive batched RMQ. Returns (leftmost argmin idx int32, value).

    Bit-identical to ``block_rmq.query`` on the same batch.
    """
    return dispatch_by_length(l, r, s.threshold, s.short_fn, s.long_fn, s.x.dtype, s.x.device)


def _measure(kind: str, fn, lj, rj, repeats: int) -> float:
    """Median wall seconds of one call of a path (after one warmup call).

    Each call ends in ``torch.cuda.synchronize()`` when the bounds live on
    the card, so the time is the call's, launch to answer. ``kind`` names
    the path ("short" / "long", or a kernel config) purely so tests can swap
    this out for a deterministic fake and pin the control flow of
    ``calibrate`` and of the autotuner.
    """
    del kind
    sync = torch.cuda.synchronize if lj.device.type == "cuda" else (lambda: None)
    fn(lj, rj)  # warmup (and the first launch's kernel build)
    sync()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(lj, rj)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _packed32_proxy(rng, n: int) -> np.ndarray:
    """The int32 array packed32 calibration times: the reference's values
    in [-1000, 1000) where their span fits the words beside ``n``'s index
    bits (n <= 2^20), else the widest span that does. The reference keeps
    [-1000, 1000) at every n, so its packed32 calibration raises above
    2^20 (ROADMAP.md §3)."""
    span = min(2000, np.iinfo(np.int32).max >> packing.idx_bits_for(n))
    return rng.integers(-(span // 2), span - span // 2, size=n).astype(np.int32)


def calibrate(
    n: int,
    batch: int = 4096,
    *,
    block_size: int = 128,
    use_kernels: bool | None = None,
    seed: int = 0,
    repeats: int = 3,
    mesh=None,
    axis_names=None,
    mode: str = "shard_structure",
    layout: str | None = None,
    device=None,
) -> int:
    """Time both constituent paths across range lengths; return the crossover.

    Sweeps log-spaced range lengths, measures the per-call median of each
    path on a ``batch``-sized query load on ``device``, and returns the
    largest swept length at which the short (blocked) path still wins, the
    value to pass as ``threshold`` given the ``len <= threshold -> short``
    routing: ``n`` when the short path wins everywhere, ``0`` (route
    everything long) when the long path wins even at length 1.

    ``layout`` measures the packed constituents (cache key v3). packed32's
    key-range precondition is data-dependent, so that measurement runs over
    a narrow-range int32 proxy array (``_packed32_proxy``); the other
    layouts keep the float proxy.

    With ``mesh`` (+ optional ``axis_names``/``mode``) the *sharded*
    constituents are measured — the sharded blocked path and the sharded
    doubling table in that distribution mode, on the mesh's devices
    (``device`` and ``use_kernels`` are then unused: the mesh engines run
    no kernel, as the reference's do not) — so the threshold reflects the
    merge costs on that mesh.
    """
    rng = np.random.default_rng(seed)
    if layout == "packed32":
        x = _packed32_proxy(rng, n)
    else:
        x = rng.random(n, dtype=np.float32)
    if mesh is None:
        dev = resolve(device)
        s = build(x, block_size, use_kernels=use_kernels, packed=layout, device=dev)
        short_fn, long_fn = s.short_fn, s.long_fn
    else:
        # Deferred import: sharded_hybrid builds on this module's dispatcher.
        from . import sharded_hybrid

        sh = sharded_hybrid.build(x, mesh, axis_names, block_size, threshold=0, mode=mode, packed=layout)
        dev = sh.device
        short_fn = lambda l, r: sh.short_fn(sh.blocked, l, r)
        long_fn = lambda l, r: sh.long_fn(sh.st, l, r)

    lengths = np.unique(np.geomspace(1, n, num=8).astype(np.int64).clip(1, n))
    crossover = None
    prev_length = 0
    for length in lengths:
        lo = rng.integers(0, max(n - length + 1, 1), batch)
        lj = as_index(lo, dev)
        rj = as_index(np.minimum(lo + length - 1, n - 1), dev)

        if _measure("long", long_fn, lj, rj, repeats) < _measure("short", short_fn, lj, rj, repeats):
            # The long path wins at `length`; routing is `len <= threshold ->
            # short`, so the threshold is the last length where short won.
            crossover = int(prev_length)
            break
        prev_length = int(length)
    if crossover is None:
        crossover = prev_length  # short path won at every swept length (= n)
    return crossover  # 0 => route everything long (long won even at len 1)
