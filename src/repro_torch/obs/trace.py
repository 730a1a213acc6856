"""Lightweight request-lifecycle span tracer (DESIGN.md §14).

A **span** is one named, timed unit of work: monotonic start/end stamps
(``time.perf_counter``), a process-unique id, an optional parent id, and a
small key/value attr dict. While a ``torch.profiler`` records on the
calling thread, ``Tracer.span`` also enters
``torch.profiler.record_function(name)``, so the span shows as a host event
on the profiler's clock, beside the device operations it launched; that
holds for the disabled tracer too. ``tracing()`` says whether either is on.
Spans form trees — the serving layer opens a ``request`` root per client
request and hangs ``admission``/``queue``/``resolve`` children off it, the
batcher opens a ``flush`` root per coalesced launch with
``coalesce``/``launch``/``scatter`` children, ``core.hybrid`` opens a
``dispatch`` root per batch over its phases, and the build/update
pipelines ride the ``core.build.run_stages`` sequencer so every stage
(``local_build``, ``apply_deltas``, ``publish``, ...) lands as a span under
whatever was current. Cross-thread parenting is explicit (pass
``parent=``); same-thread nesting is ambient via a ``contextvars`` current
span, which thread boundaries naturally reset.

Design constraints, in order:

1. **Zero cost when disabled.** The default global tracer is a shared
   disabled singleton: with no profiler recording, ``span()`` returns one
   reusable no-op context manager after one flag check, ``start()`` returns
   one reusable no-op span, and neither path allocates (asserted by
   tracemalloc probes in tests/test_obs.py and
   tests/test_torch_obs_dispatch.py). Hot paths gate attr-dict
   construction on ``tracer.enabled``. torch is imported lazily, by the
   first ``span()`` call, so this module stays importable without it.
2. **Bounded memory.** Finished spans land in a thread-safe ring buffer
   (``deque(maxlen=capacity)``): overflow drops the *oldest* spans, so a
   long soak keeps its newest history.
3. **Standard export.** ``to_chrome_trace()`` / ``export(path)`` emit the
   Chrome-trace JSON event format (``"X"`` complete events + ``"M"``
   thread-name metadata) that chrome://tracing and https://ui.perfetto.dev
   open directly; span/parent ids ride in ``args`` so the request chains
   survive the export.

``verify_request_chains`` is the acceptance-side consumer: it walks an
exported (or live) span set and checks that every successfully resolved
request has the complete admission→queue→resolve chain plus a linked flush
tree with launch (carrying engine/regime/layout/kernel attrs) and scatter.
check.sh's observability gate and ``launch/serve.py --trace`` both call it.
"""

from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from contextvars import ContextVar
from time import perf_counter
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "NULL_TRACER",
    "Span",
    "Tracer",
    "current_span",
    "get_tracer",
    "set_attr",
    "set_tracer",
    "tracing",
    "verify_request_chains",
]

_ids = itertools.count(1)
_CURRENT: ContextVar[Optional["Span"]] = ContextVar("repro_obs_span", default=None)


class Span:
    """One timed unit of work. Mutable until finished; see module docstring."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs", "thread")

    def __init__(self, name: str, parent_id: Optional[int], attrs: Optional[dict]):
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = parent_id
        self.t0 = perf_counter()
        self.t1: Optional[float] = None
        self.attrs: dict = attrs if attrs is not None else {}
        self.thread = threading.current_thread().name

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else perf_counter()) - self.t0

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Span({self.name!r}, id={self.span_id}, parent={self.parent_id})"


class _NoopSpan:
    """Shared do-nothing span: the disabled tracer hands out ONE of these."""

    __slots__ = ()
    name = ""
    span_id = 0
    parent_id = None
    t0 = 0.0
    t1 = 0.0
    attrs: dict = {}
    thread = ""
    duration_s = 0.0

    def set_attr(self, key: str, value) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class _NoopCtx:
    """Shared reusable no-op context manager (zero allocations per use)."""

    __slots__ = ()

    def __enter__(self) -> _NoopSpan:
        return _NOOP_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_CTX = _NoopCtx()

_profiler_enabled = None  # torch's flag read, bound by the first _profiling()


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records on this thread (about 0.1 µs)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        import torch

        _profiler_enabled = torch._C._autograd._profiler_enabled
    return _profiler_enabled()


class _ProfiledCtx:
    """A span's context inside ``torch.profiler.record_function(name)``."""

    __slots__ = ("_rf", "_inner")

    def __init__(self, name: str, inner):
        import torch

        self._rf = torch.profiler.record_function(name)
        self._inner = inner

    def __enter__(self):
        self._rf.__enter__()
        return self._inner.__enter__()

    def __exit__(self, *exc) -> bool:
        try:
            return self._inner.__exit__(*exc)
        finally:
            self._rf.__exit__(*exc)


class _SpanCtx:
    """Context manager for one live span: finishes it and restores the
    ambient current span on exit (same-thread nesting)."""

    __slots__ = ("_tracer", "_span", "_token")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.attrs.setdefault("error", exc_type.__name__)
        _CURRENT.reset(self._token)
        self._tracer.finish(self._span)
        return False


class Tracer:
    """Thread-safe span recorder over a fixed-capacity ring buffer.

    ``enabled=False`` constructs the degenerate tracer every call site can
    keep unconditionally: all methods are no-ops that allocate nothing.
    """

    def __init__(self, *, enabled: bool = True, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=self.capacity)
        self._dropped = 0
        self._t_epoch = perf_counter()  # export time origin

    # -- recording ----------------------------------------------------------

    def start(
        self, name: str, *, parent=None, attrs: Optional[dict] = None
    ) -> Span:
        """Begin a span (not yet in the buffer). ``parent`` is a Span, a span
        id, or None (= the ambient current span, if any)."""
        if not self.enabled:
            return _NOOP_SPAN
        if parent is None:
            cur = _CURRENT.get()
            pid = cur.span_id if cur is not None else None
        elif isinstance(parent, int):
            pid = parent or None
        else:
            pid = parent.span_id or None
        return Span(name, pid, attrs)

    def finish(self, span) -> None:
        """Stamp the end time and commit the span to the ring buffer."""
        if not self.enabled or span is _NOOP_SPAN:
            return
        if span.t1 is None:
            span.t1 = perf_counter()
        with self._lock:
            if len(self._buf) == self.capacity:
                self._dropped += 1
            self._buf.append(span)

    def span(self, name: str, *, parent=None, attrs: Optional[dict] = None):
        """Context manager: start + make-current + finish, and a
        ``record_function(name)`` while a profiler records. Zero-alloc no-op
        when neither is on (the shared context manager is reused)."""
        ctx = _SpanCtx(self, self.start(name, parent=parent, attrs=attrs)) if self.enabled else _NOOP_CTX
        if _profiling():
            return _ProfiledCtx(name, ctx)
        return ctx

    def instant(self, name: str, *, parent=None, attrs: Optional[dict] = None) -> Span:
        """A zero-duration marker span, committed immediately."""
        if not self.enabled:
            return _NOOP_SPAN
        s = self.start(name, parent=parent, attrs=attrs)
        self.finish(s)
        return s

    # -- introspection / export ---------------------------------------------

    @property
    def dropped(self) -> int:
        """Spans evicted by ring-buffer overflow (newest are kept)."""
        with self._lock:
            return self._dropped

    def spans(self) -> List[Span]:
        """Snapshot of the buffered (finished) spans, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def to_chrome_trace(self) -> dict:
        """The trace as a Chrome-trace/Perfetto JSON object (see module doc)."""
        spans = self.spans()
        tids: Dict[str, int] = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s.thread, len(tids) + 1)
            args = {"span_id": s.span_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            for k, v in s.attrs.items():
                args[k] = v if isinstance(v, (int, float, str, bool, type(None))) else str(v)
            t1 = s.t1 if s.t1 is not None else s.t0
            events.append(
                {
                    "name": s.name,
                    "ph": "X",
                    "ts": (s.t0 - self._t_epoch) * 1e6,  # µs, monotonic origin
                    "dur": max(0.0, (t1 - s.t0) * 1e6),
                    "pid": 1,
                    "tid": tid,
                    "cat": "repro",
                    "args": args,
                }
            )
        for name, tid in tids.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tid,
                    "args": {"name": name},
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Chrome-trace JSON to ``path``; returns the span count."""
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")


NULL_TRACER = Tracer(enabled=False, capacity=1)
_GLOBAL = NULL_TRACER
_GLOBAL_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer (the disabled singleton until configured)."""
    return _GLOBAL


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` globally (None restores the disabled singleton);
    returns the previous global so callers/tests can restore it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev = _GLOBAL
        _GLOBAL = tracer if tracer is not None else NULL_TRACER
        return prev


def tracing() -> bool:
    """Whether spans record anywhere: the global tracer is enabled or a
    ``torch.profiler`` records on this thread. Gates work done only for
    the trace (attrs, stage spans, device timing events)."""
    return _GLOBAL.enabled or _profiling()


def current_span() -> Optional[Span]:
    """This context's ambient span (None outside any ``span()`` block)."""
    return _CURRENT.get()


def set_attr(key: str, value) -> None:
    """Annotate the ambient span, if any — the seam engine internals use
    (e.g. ``update.engines`` stamping a patch's write counts) without
    holding a tracer reference. No-op when nothing is current."""
    cur = _CURRENT.get()
    if cur is not None:
        cur.attrs[key] = value


# -- chain verification --------------------------------------------------------

# The per-request lifecycle contract (DESIGN.md §14): a resolved request span
# must carry these children, and its flush span these.
_REQUEST_CHILDREN = ("admission", "queue", "resolve")
_FLUSH_CHILDREN = ("launch", "scatter")
_LAUNCH_ATTRS = ("engine",)


def _spans_from_chrome(doc: dict) -> List[dict]:
    out = []
    for e in doc.get("traceEvents", ()):
        if e.get("ph") != "X":
            continue
        args = dict(e.get("args", {}))
        out.append(
            {
                "name": e["name"],
                "span_id": args.pop("span_id", None),
                "parent_id": args.pop("parent_id", None),
                "attrs": args,
            }
        )
    return out


def _normalize(spans) -> List[dict]:
    if isinstance(spans, dict):
        return _spans_from_chrome(spans)
    out = []
    for s in spans:
        if isinstance(s, dict):
            out.append(s)
        else:
            out.append(
                {
                    "name": s.name,
                    "span_id": s.span_id,
                    "parent_id": s.parent_id,
                    "attrs": dict(s.attrs),
                }
            )
    return out


def verify_request_chains(spans) -> Tuple[int, List[str]]:
    """Check every resolved request's span chain for completeness.

    ``spans`` is a list of ``Span``s, a list of dicts, or a parsed
    Chrome-trace document (``{"traceEvents": [...]}``). For each ``request``
    span whose ``resolve`` child carries ``outcome == "ok"``, require:

    * children named ``admission``, ``queue`` and ``resolve`` (no orphans);
    * a ``batch`` attr naming an exported ``flush`` span;
    * that flush span owning ``launch`` and ``scatter`` children, the launch
      carrying an ``engine`` attr (regime/layout/kernel attrs ride there).

    Returns ``(complete_count, problems)`` — ``problems`` is empty iff every
    resolved request has a complete chain.
    """
    rows = _normalize(spans)
    by_id = {r["span_id"]: r for r in rows if r["span_id"] is not None}
    kids: Dict[int, List[dict]] = {}
    for r in rows:
        pid = r.get("parent_id")
        if pid is not None:
            kids.setdefault(pid, []).append(r)

    complete = 0
    problems: List[str] = []
    for r in rows:
        if r["name"] != "request":
            continue
        rid = r["span_id"]
        names = {c["name"] for c in kids.get(rid, ())}
        resolve = next(
            (c for c in kids.get(rid, ()) if c["name"] == "resolve"), None
        )
        if resolve is None or resolve["attrs"].get("outcome") != "ok":
            continue  # failed/expired/closed requests need no full chain
        missing = [n for n in _REQUEST_CHILDREN if n not in names]
        if missing:
            problems.append(f"request {rid}: missing children {missing}")
            continue
        bid = r["attrs"].get("batch")
        flush = by_id.get(bid)
        if flush is None or flush["name"] != "flush":
            problems.append(f"request {rid}: batch attr {bid!r} is not a flush span")
            continue
        fnames = {c["name"] for c in kids.get(bid, ())}
        fmissing = [n for n in _FLUSH_CHILDREN if n not in fnames]
        if fmissing:
            problems.append(f"request {rid}: flush {bid} missing {fmissing}")
            continue
        launch = next(c for c in kids.get(bid, ()) if c["name"] == "launch")
        amissing = [a for a in _LAUNCH_ATTRS if a not in launch["attrs"]]
        if amissing:
            problems.append(f"request {rid}: launch missing attrs {amissing}")
            continue
        complete += 1
    return complete, problems
