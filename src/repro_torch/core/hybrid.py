"""Range-adaptive hybrid RMQ dispatcher (the paper's crossover, exploited).

The blocked structure is fastest for *short* ranges; the O(1) sparse table
overtakes it at medium and large ranges. A batch is partitioned by range
length against a threshold on the structure's device: short ranges go to
the blocked path (the fused CUDA kernel ``kernels.ops`` when
``use_kernels``, else the plain ``block_rmq``), long ranges to the sparse
table over the raw array, and the two result sets are gathered back into
batch order there. Results equal
``block_rmq.query`` bit for bit. With ``packed=`` both tiers hold packed
(value, index) words (``core.packing``); the short path then runs the
``fused_query_packed`` kernel for every layout (packed64, packed32,
quantized). ``calibrate`` measures the
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

from repro_torch._device import as_index, resolve
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
    use_kernels: bool  # short path: a CUDA kernel serves it (else plain block_rmq)
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
    With ``use_kernels`` a CUDA kernel serves the short path, for unpacked
    parts and every packed layout, and for unpacked parts another serves the
    long path (``ops.sparse_query``; packed tables keep
    ``sparse_table.query_packed``).
    """
    if spec is not None:
        if use_kernels:
            from repro_torch.kernels import ops

            short_fn = lambda l, r: ops.query_packed(blocked, spec, l, r, config=kernel_config)
        else:
            short_fn = lambda l, r: block_rmq.query_packed(blocked, spec, l, r)
        long_fn = lambda l, r: sparse_table.query_packed(st, spec, l, r)
    else:
        if use_kernels:
            from repro_torch.kernels import ops

            short_fn = lambda l, r: ops.query(blocked, l, r, config=kernel_config)
            long_fn = lambda l, r: ops.sparse_query(st.idx, x, l, r)
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


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)
    return np.issubdtype(dtype, np.integer)


def _count_copy(reg, direction: str, nbytes: int) -> None:
    reg.counter("dispatch_copy_bytes_total", direction=direction).inc(nbytes)


def _as_tensor(a) -> torch.Tensor:
    """Integer bounds (a tensor or a numpy array) as a 1-D tensor where they
    live, in their own integer width (unsigned ones wider than a byte as
    int64); a host array is wrapped, not copied, where numpy allows."""
    if not isinstance(a, torch.Tensor):
        if a.dtype.kind == "u" and a.dtype.itemsize > 1:
            a = a.astype(np.int64)
        a = torch.from_numpy(np.ascontiguousarray(a))
    elif a.dtype in (torch.uint16, torch.uint32, torch.uint64):
        a = a.to(torch.int64)
    return a.reshape(-1)


def _to_device(a: torch.Tensor, device, reg) -> torch.Tensor:
    """``a`` on ``device``; a copy between host and device is counted."""
    if a.device != device:
        if a.device.type == "cpu" or device.type == "cpu":
            _count_copy(reg, "h2d" if a.device.type == "cpu" else "d2h", a.nbytes)
        a = a.to(device)
    return a


def _short_mask(l: torch.Tensor, r: torch.Tensor, threshold: int) -> torch.Tensor:
    """``r - l + 1 <= threshold``, as ``r - l <= threshold - 1``: in int32
    when both bounds are (``r - l`` of bounds in [0, 2^31 - 1] cannot wrap,
    and a batch outside that range raises before any launch), else int64."""
    wd = torch.int32 if l.dtype == r.dtype == torch.int32 else torch.int64
    lim = torch.iinfo(wd)
    return (r.to(wd) - l.to(wd)) <= min(max(threshold - 1, lim.min), lim.max)


def _pow2(k: int) -> int:
    """The launch length of ``k`` queries: the next power of two, as the
    reference pads to bound its jit cache (the same launch shapes here)."""
    return 1 << (k - 1).bit_length() if k > 1 else 1


def _padded(l, r, kp: int):
    """Both bounds as int32 launch arrays of length ``kp``, padded with
    (0, 0) queries; the bounds themselves where no pad or cast is needed."""
    if l.numel() == kp and l.dtype == r.dtype == torch.int32:
        return l.contiguous(), r.contiguous()
    buf = torch.zeros((2, kp), dtype=torch.int32, device=l.device)
    buf[0, : l.numel()] = l
    buf[1, : r.numel()] = r
    return buf[0], buf[1]


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

    The batch is partitioned by range length against ``threshold`` on
    ``device``, where the structure lives: each path's queries go, in batch
    order and padded to a power of two with (0, 0) queries, through
    ``short_fn`` / ``long_fn`` (each ``(l, r) -> (idx, val)`` on int32
    tensors on ``device``), and the answers are gathered back into batch
    order there. The bounds' least and greatest value and the short count,
    which the range check and the launch shapes need, are read where the
    bounds live, before any copy: one blocking read back of three numbers
    for bounds on a card, none for host bounds. Bounds already on
    ``device`` are not copied; host bounds (numpy, lists, CPU tensors) then
    go up once, in their own integer width. Nothing else of the batch or its
    answers crosses between host and device. Empty batches return empty
    ``(idx, val)`` without launching anything.

    Bounds must be integer arrays inside the int32 index range: every
    constituent computes int32 indices, so an out-of-range bound would wrap
    silently instead of failing loudly. The check happens before anything
    launches.

    Traced as a ``dispatch`` span (attrs ``short``, ``long``: the split)
    over the phases ``dispatch.bounds`` (the length mask and the read of the
    three numbers where the bounds live, the range check, the upload of host
    bounds), ``dispatch.partition``
    (the padded launch arrays), ``dispatch.launch`` (one per path launched)
    and, for mixed batches, ``dispatch.scatter`` (the answers gathered into
    batch order). Counted always in ``obs.metrics.default_registry()``:
    ``dispatch_batches_total``, ``dispatch_host_syncs_total`` (the reads of
    the three numbers: one a non-empty batch, blocking where the bounds are
    on a card), ``dispatch_copy_bytes_total{direction}`` (``d2h`` /
    ``h2d``: the bytes of every copy between host and device) and
    ``dispatch_launched_queries_total{path}`` (the queries launched on each
    path, the (0, 0) pads included: what the kernels' own
    ``query_kernel_queries_total`` is held against).
    While ``obs.trace.tracing()`` on a CUDA device, each launch's device time
    goes to ``dispatch_path_device_s{path}`` (``short`` / ``long``), observed
    at a later call once the launch has completed.
    """
    if _device_times:
        _observe_device_times()
    tr = obs_trace.get_tracer()
    reg = default_registry()
    reg.counter("dispatch_batches_total").inc()
    device = torch.device(device)
    with tr.span("dispatch") as span:
        with tr.span("dispatch.bounds"):
            l, r = (a if isinstance(a, torch.Tensor) else np.asarray(a) for a in (l, r))
            if not (_is_integer(l.dtype) and _is_integer(r.dtype)):
                raise TypeError(f"query bounds must be integer arrays, got {l.dtype} / {r.dtype}")
            l, r = _as_tensor(l), _as_tensor(r)
            if l.shape != r.shape:
                raise ValueError(f"query bounds of unequal length: {l.numel()} / {r.numel()}")
            n = l.numel()
            if n == 0:  # nothing to do: no phantom padded query, no launch
                return (
                    torch.zeros(0, dtype=torch.int32, device=device),
                    torch.zeros(0, dtype=out_dtype, device=device),
                )
            # The batch's one read of three numbers, where the bounds live
            # (a blocking read back on a card, a pass over the arrays on the
            # host; never a copy to read them): the range check and the
            # launch shapes need them.
            short = _short_mask(l, r, threshold)
            lo, hi, n_short = torch.stack(
                (l.min().to(torch.int64), r.max().to(torch.int64), short.sum())
            ).tolist()
            reg.counter("dispatch_host_syncs_total").inc()
            if l.device.type != "cpu":
                _count_copy(reg, "d2h", 3 * 8)
            if lo < 0 or hi > _INT32_MAX:
                raise ValueError(f"query bounds [{lo}, {hi}] outside the engines' int32 index range")
            if l.device != device:  # host bounds go up once, in their own width
                l, r, short = _to_device(l, device, reg), _to_device(r, device, reg), None

        with tr.span("dispatch.partition"):
            n_long = n - n_short
            cb = getattr(_split_sink, "cb", None)
            if cb is not None:
                cb(n_short, n_long)
            if tr.enabled:
                span.set_attr("short", n_short)
                span.set_attr("long", n_long)
            if n_short == 0 or n_long == 0:
                # Uniform batches skip the partition and the scatter.
                parts = [("short" if n_short else "long", *_padded(l, r, _pow2(n)), n)]
            else:
                # One slot per query in a buffer whose two halves are the
                # padded sub-batches: short queries fill the first in batch
                # order, long ones the second from kp_short on.
                if short is None:  # the bounds moved: the mask again, where they are now
                    short = _short_mask(l, r, threshold)
                kp_short = _pow2(n_short)
                it = torch.int32 if kp_short + n <= _INT32_MAX else torch.int64
                cs = torch.cumsum(short, 0, dtype=it)
                slots = torch.arange(kp_short, kp_short + n, dtype=it, device=device)
                pos = torch.where(short, cs - 1, slots - cs)
                buf = torch.zeros((2, kp_short + _pow2(n_long)), dtype=torch.int32, device=device)
                pos64 = pos.long()  # index_put_ would widen int32 indices at each call
                buf[0, pos64] = l.to(torch.int32)
                buf[1, pos64] = r.to(torch.int32)
                parts = [
                    ("short", buf[0, :kp_short], buf[1, :kp_short], n_short),
                    ("long", buf[0, kp_short:], buf[1, kp_short:], n_long),
                ]

        timed = device.type == "cuda" and obs_trace.tracing()
        launched = []
        for path, lp, rp, k in parts:
            reg.counter("dispatch_launched_queries_total", path=path).inc(lp.numel())
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
            launched.append((qi, qv, k))

        if len(launched) == 1:
            qi, qv, k = launched[0]
            out = qi[:k], qv[:k]
        else:
            # Mixed batch: both paths' padded answers side by side are laid
            # out as the slots, so the slot map gathers them into batch order.
            with tr.span("dispatch.scatter"):
                (si, sv, _), (li, lv, _) = launched
                out = (
                    torch.index_select(torch.cat((si, li.to(si.dtype))), 0, pos),
                    torch.index_select(torch.cat((sv, lv.to(sv.dtype))), 0, pos),
                )
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
