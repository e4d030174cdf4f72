"""Hierarchical tracing: spans over the telemetry event spine.

Port of ``mosaic_tpu/obs/trace.py``. A *span* is one named, timed unit
of work (``join.pip``, one forced probe lane) with identity —
``trace_id`` shared by every span of one logical operation, ``span_id``
unique per span, ``parent_id`` linking child to parent. Ending a span
records one ``event="span"`` dict through `runtime/telemetry.py`, and
every other event recorded while a span is active on the thread is
stamped with the span's ids — a retry, an escalation, a watchdog stall
or a degradation is thereby attached to the join it happened in.

Context propagation is explicit: the active span stack is thread-local;
:func:`current_context` returns the innermost active
:class:`SpanContext`, and a worker thread calls :func:`adopt_context`
with it to join the caller's trace (the watchdog does, through
``telemetry.adopt_trace``). A *detached* span (:func:`start_span`
``detached=True``) gets ids and a parent from the ambient context but
does not occupy the caller's stack.

Ids are 128-bit (trace) / 64-bit (span) random hex. Everything here is
stdlib-only and imports nothing above ``runtime/telemetry.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

from ..runtime import telemetry as _telemetry

_LOCAL = threading.local()


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """The propagatable identity of a span: what a child needs to link
    to it, and nothing else (safe to serialize)."""

    trace_id: str
    span_id: str

    def as_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d: dict | None) -> "SpanContext | None":
        if not d or not d.get("trace_id") or not d.get("span_id"):
            return None
        return cls(str(d["trace_id"]), str(d["span_id"]))


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Span:
    """One in-flight span. Prefer the :func:`span` context manager; use
    :func:`start_span`/:meth:`end` directly when begin and end live on
    different threads (request lifecycles)."""

    __slots__ = (
        "name", "context", "parent_id", "attrs",
        "_t0", "_start_mono", "_stack", "_ended",
    )

    def __init__(
        self, name: str, context: SpanContext, parent_id: str | None,
        attrs: dict, stack: list | None,
    ):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = time.perf_counter()
        self._start_mono = round(time.monotonic(), 6)
        self._stack = stack
        self._ended = False

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes (recorded at end)."""
        self.attrs.update(attrs)
        return self

    def end(self, **attrs) -> dict | None:
        """Record the span event and release it (idempotent — a request
        span may race completion against shutdown shedding; the first
        end wins). Safe to call from a thread other than the starter:
        only the starter's stack is touched, via the shared list."""
        if self._ended:
            return None
        self._ended = True
        if self._stack is not None and self in self._stack:
            self._stack.remove(self)
        self.attrs.update(attrs)
        return _telemetry.record(
            "span",
            name=self.name,
            trace_id=self.context.trace_id,
            span_id=self.context.span_id,
            parent_id=self.parent_id,
            seconds=round(max(time.perf_counter() - self._t0, 0.0), 6),
            start_mono=self._start_mono,
            **self.attrs,
        )


def start_span(
    name: str,
    *,
    parent: SpanContext | None = None,
    detached: bool = False,
    **attrs,
) -> Span:
    """Begin a span; the caller owns calling :meth:`Span.end`.

    ``parent`` overrides the ambient context (the innermost active span
    on this thread, else an :func:`adopt_context` adoption); with
    neither, the span roots a NEW trace. ``detached=True`` keeps the
    span off this thread's stack: it gets identity and parentage but
    does not become the ambient parent of subsequent sibling spans —
    request-lifetime roots use this so two requests submitted back to
    back from one thread do not nest.
    """
    if parent is None:
        parent = current_context()
    trace_id = parent.trace_id if parent is not None else _new_trace_id()
    ctx = SpanContext(trace_id, _new_span_id())
    stack = None if detached else _stack()
    sp = Span(
        name, ctx,
        parent.span_id if parent is not None else None,
        dict(attrs), stack,
    )
    if stack is not None:
        stack.append(sp)
    return sp


@contextlib.contextmanager
def span(name: str, *, parent: SpanContext | None = None, **attrs):
    """Span a block: ``with span("join.pip", n=n): ...``.

    On an exception the span is stamped ``error=<type name>`` (matching
    ``telemetry.timed``) and the exception re-raises; the span event is
    recorded either way.
    """
    sp = start_span(name, parent=parent, **attrs)
    try:
        yield sp
    except BaseException as e:  # noqa: BLE001 — stamped and re-raised
        sp.set(error=type(e).__name__)
        raise
    finally:
        sp.end()


def current_context() -> SpanContext | None:
    """The innermost active span's context on this thread — else the
    context this thread :func:`adopt_context`-ed, else None. Hand it to
    a worker thread (or persist it) to keep one logical operation one
    trace."""
    stack = getattr(_LOCAL, "stack", None)
    if stack:
        return stack[-1].context
    return getattr(_LOCAL, "base", None)


def adopt_context(context: SpanContext | None) -> None:
    """Make ``context`` (a :func:`current_context` result from another
    thread, or a :class:`SpanContext` restored with ``from_dict``) this
    thread's ambient parent. Spans started here join that trace;
    events recorded here are stamped with it. ``None`` clears the
    adoption."""
    _LOCAL.base = context


class _Tracer:
    """The `runtime/telemetry.py` provider: stamps events, carries
    contexts across threads (``telemetry.current_trace``/
    ``adopt_trace`` delegate here so runtime modules never import
    obs)."""

    def ids(self) -> dict | None:
        ctx = current_context()
        if ctx is None:
            return None
        return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}

    def current(self):
        return current_context()

    def adopt(self, context) -> None:
        adopt_context(context)


_TRACER = _Tracer()
_telemetry.register_tracer(_TRACER)
