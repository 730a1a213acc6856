"""A closed loop with one caller, as a GPU application runs it: ask one batch,
wait for its answers on the device, ask the next. The pool's batches are
offered in turn."""

from __future__ import annotations

import time


def drive(call, pool, sync, *, seconds=None, count=None, first=0, on_batch=None, span=None) -> dict:
    """Offer batches until ``seconds`` have passed (checked after each batch)
    or ``count`` batches are done. ``call(l, r)`` is the program's query,
    ``sync()`` waits for the device; ``on_batch(i, pool_index, answer)`` sees
    each answer; ``span(name)`` is a context manager around each call and
    each wait (the traced slice's spans), or None.

    Returns the window: its seconds (the first call to the last answer), its
    batches and queries, and per batch the seconds from the call to the
    answers synchronized (``batch_s``) and from the call to its return
    (``host_s``)."""
    if seconds is None and count is None:
        raise ValueError("drive needs seconds or count")
    batch_s, host_s, queries = [], [], 0
    clock = time.perf_counter
    t0 = t = clock()
    i = 0
    while (count is None or i < count) and (seconds is None or i == 0 or t - t0 < seconds):
        p = (first + i) % len(pool)
        l, r = pool[p]
        ta = clock()
        if span is None:
            out = call(l, r)
            tb = clock()
            sync()
        else:
            with span("bench.query"):
                out = call(l, r)
            tb = clock()
            with span("bench.sync"):
                sync()
        t = clock()
        batch_s.append(t - ta)
        host_s.append(tb - ta)
        queries += int(l.shape[0])
        if on_batch is not None:
            on_batch(i, p, out)
        i += 1
    return {
        "seconds": t - t0,
        "batches": i,
        "queries": queries,
        "batch_s": batch_s,
        "host_s": host_s,
    }
