"""Structured resilience telemetry.

Port of ``mosaic_tpu/runtime/telemetry.py``. Every escalation attempt,
transient retry, fault injection and degradation emits one flat event
dict here. Events go to the ``mosaic_tpu_torch.runtime`` logger only
when that logger is enabled; tests and services subscribe with
:func:`capture` to assert on (or export) the exact trail.

Observability hooks: :func:`register_tracer` (``obs/trace.py`` installs
the span-context provider at import, so events recorded under an active
span carry its ids, and :func:`current_trace`/:func:`adopt_trace` carry
the span to worker threads) and :func:`add_observer` (process-wide event
observers). Both are no-ops until registered, so the runtime layer never
depends on the observability layer.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import os
import threading
import time

_LOCAL = threading.local()

#: process-wide event sequence — ``itertools.count`` increments under the
#: GIL, so concurrent recorders (watchdog workers) still get unique,
#: strictly increasing numbers
_SEQ = itertools.count()

_LOGGER = logging.getLogger("mosaic_tpu_torch.runtime")

#: per-process incarnation id, minted once at import:
#: ``<start-unix-seconds:8 hex>-<pid>-<random:6 hex>``; snapshot sidecars
#: are stamped with it, so the process that wrote each one is known
INCARNATION = f"{int(time.time()):08x}-{os.getpid()}-{os.urandom(3).hex()}"

#: registered by ``obs/trace.py`` — an object with ``ids() -> dict |
#: None``, ``current() -> context | None`` and ``adopt(context) -> None``
_TRACER = None

#: process-wide event observers (``fn(evt) -> None``)
_OBSERVERS: list = []


def _sinks() -> list:
    sinks = getattr(_LOCAL, "sinks", None)
    if sinks is None:
        sinks = _LOCAL.sinks = []
    return sinks


def current_sinks() -> list:
    """This thread's live sink list — hand it to :func:`adopt_sinks` on
    a worker thread so events recorded there still reach the caller's
    :func:`capture` scopes."""
    return _sinks()


def adopt_sinks(sinks: list) -> None:
    """Make ``sinks`` (a :func:`current_sinks` result from another
    thread) this thread's sink list."""
    _LOCAL.sinks = sinks


def register_tracer(tracer) -> None:
    """Install the span-context provider (``obs/trace.py`` calls this at
    import)."""
    global _TRACER
    _TRACER = tracer


def current_trace():
    """The calling thread's active span context (opaque; hand it to
    :func:`adopt_trace` on a worker), or None."""
    return None if _TRACER is None else _TRACER.current()


def adopt_trace(context) -> None:
    """Adopt a :func:`current_trace` result on this thread (no-op without
    a tracer or with ``context=None``)."""
    if _TRACER is not None and context is not None:
        _TRACER.adopt(context)


def add_observer(fn) -> None:
    """Register a process-wide event observer (``fn(evt)``)."""
    if fn not in _OBSERVERS:
        _OBSERVERS.append(fn)


def remove_observer(fn) -> None:
    """Unregister an :func:`add_observer` observer (idempotent)."""
    if fn in _OBSERVERS:
        _OBSERVERS.remove(fn)


def record(event: str, **fields) -> dict:
    """Emit one structured event: ``{"event": event, "seq": n,
    "ts_mono": t, **fields}``.

    ``seq`` is strictly increasing per process and ``ts_mono`` a
    monotonic-clock stamp, so event streams are totally ordered. Under an
    active span the event is stamped with ``trace_id``/``span_id``
    (explicitly passed fields win). With no sinks, no observers and the
    logger disabled, nothing is formatted or emitted.
    """
    evt = {
        "event": event,
        "seq": next(_SEQ),
        "ts_mono": round(time.monotonic(), 6),
        **fields,
    }
    if _TRACER is not None and "trace_id" not in evt:
        ids = _TRACER.ids()
        if ids is not None:
            evt.update(ids)
    for sink in _sinks():
        sink.append(evt)
    for obs in _OBSERVERS:
        obs(evt)
    if _LOGGER.isEnabledFor(logging.INFO):
        _LOGGER.info("%s %s", event, fields)
    return evt


@contextlib.contextmanager
def timed(event: str, **fields):
    """Record ``event`` with a measured ``seconds`` field around the
    block. A block that raises still records its event, stamped
    ``error=<exception type name>``, and the exception re-raises."""
    t0 = time.perf_counter()
    err: str | None = None
    try:
        yield
    except BaseException as e:  # noqa: BLE001 — stamped and re-raised
        err = type(e).__name__
        raise
    finally:
        extra = {} if err is None else {"error": err}
        record(
            event,
            seconds=round(max(time.perf_counter() - t0, 0.0), 6),
            **fields,
            **extra,
        )


def summarize(
    events, event: str | None = None, key: str = "seconds"
) -> dict:
    """Percentile summary of one numeric field over recorded events:
    ``{"count", "p50", "p90", "p99", "mean", "max", "sum"}`` over
    ``e[key]`` (restricted to ``e["event"] == event`` when given); all
    0.0 when nothing matches. Percentiles are nearest-rank: the q-th is
    the smallest value with at least ``q*n`` samples at or below it."""
    vals = [
        float(e[key])
        for e in events
        if key in e and (event is None or e.get("event") == event)
    ]
    if not vals:
        return {
            "count": 0, "p50": 0.0, "p90": 0.0, "p99": 0.0,
            "mean": 0.0, "max": 0.0, "sum": 0.0,
        }
    vals.sort()
    n = len(vals)

    def pct(q: float) -> float:
        return vals[min(n - 1, max(0, math.ceil(q * n) - 1))]

    return {
        "count": n,
        "p50": round(pct(0.50), 6),
        "p90": round(pct(0.90), 6),
        "p99": round(pct(0.99), 6),
        "mean": round(sum(vals) / n, 6),
        "max": round(vals[-1], 6),
        "sum": round(sum(vals), 6),
    }


@contextlib.contextmanager
def capture():
    """Collect every event emitted in the block (thread-local, and on the
    worker threads that adopt this thread's sinks).

    >>> with telemetry.capture() as events:
    ...     pip_join(...)
    >>> [e for e in events if e["event"] == "capacity_overflow"]
    """
    events: list[dict] = []
    _sinks().append(events)
    try:
        yield events
    finally:
        # detach by identity: a nested capture sees the same event dicts
        # as its enclosing one, so equality would detach the outer scope
        s = _sinks()
        for i in range(len(s) - 1, -1, -1):
            if s[i] is events:
                del s[i]
                break
