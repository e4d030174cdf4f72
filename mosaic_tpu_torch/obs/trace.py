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
stdlib-only and imports nothing above ``runtime/telemetry.py``; torch is
looked up in ``sys.modules``, never imported.

Stage timing
------------
:func:`stage_timing_on` is true while a ``torch.profiler`` records, after
an operator's :func:`stage_timing` ``(True)``, or from import when
``MOSAIC_TRACE_STAGES=1``. While it is true:

- every :func:`span` block also opens a ``torch.profiler.record_function``
  range of its own name, so the program's spans stand in the profiler's
  Chrome trace on the kernels' clock (a detached span opens none);
- :func:`stage_span` blocks record child spans at the stage boundaries of
  the host entry and the stream loop: ``join.pip.h2d`` (attribute
  ``bytes``), ``join.pip.prepare`` (the device's shift and cast of the
  f64 points), ``join.pip.cells``, ``join.pip.counts``,
  ``join.pip.probe`` and ``join.pip.d2h`` under ``join.pip``
  (`sql/join.py pip_join`, its single-device lane), with the exact
  lane's (``recheck=True``) ``join.pip.narrow`` (the narrow re-join of
  the cell band, attribute ``rows``: the band's rows) and
  ``join.pip.oracle`` (the f64 oracle of the tie rows, attribute
  ``rows``), and ``stream.assign``, ``stream.join`` and
  ``stream.fold_pull`` under ``stream.run`` (`sql/stream.py`); the
  metric bridge folds the two ``rows`` into
  ``join.recheck_rows{lane="band"|"oracle"}``;
- a stage given ``device=`` (``join.pip.prepare``, ``join.pip.cells``,
  ``join.pip.probe``, ``join.pip.narrow``, ``stream.assign``,
  ``stream.join``) records a CUDA
  event pair on the current stream (the host clock on the CPU, whose ops
  are synchronous); its span event carries ``device_s`` and ``points``,
  read when the owning path's :func:`device_stages` block ends at the
  sync the path makes anyway (the answer's copy back, the fold pull). No
  ``synchronize`` and no read-back is added. The metric bridge folds
  those events into ``trace.stage_device_seconds{stage}`` and
  ``trace.stage_points{stage}``.

While it is false a stage boundary costs that one test: no span event,
no torch call, no CUDA event, so a default trail is the reference's,
event for event. While a CUDA graph is being captured nothing opens a
range or records a CUDA event.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
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
        "_t0", "_t1", "_start_mono", "_stack", "_ended",
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
        self._t1 = None
        self._start_mono = round(time.monotonic(), 6)
        self._stack = stack
        self._ended = False

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes (recorded at end)."""
        self.attrs.update(attrs)
        return self

    def close(self) -> None:
        """Stop the span's clock and take it off the stack, leaving its
        event to a later :meth:`end` (a device-timed stage is recorded
        once its path has synced)."""
        if self._t1 is None:
            self._t1 = time.perf_counter()
        if self._stack is not None and self in self._stack:
            self._stack.remove(self)

    def end(self, **attrs) -> dict | None:
        """Record the span event and release it (idempotent — a request
        span may race completion against shutdown shedding; the first
        end wins). Safe to call from a thread other than the starter:
        only the starter's stack is touched, via the shared list."""
        if self._ended:
            return None
        self._ended = True
        self.close()
        self.attrs.update(attrs)
        return _telemetry.record(
            "span",
            name=self.name,
            trace_id=self.context.trace_id,
            span_id=self.context.span_id,
            parent_id=self.parent_id,
            seconds=round(max(self._t1 - self._t0, 0.0), 6),
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
    rng = None
    try:
        if stage_timing_on():
            rng = _open_range(name)
        yield sp
    except BaseException as e:  # noqa: BLE001 — stamped and re-raised
        sp.set(error=type(e).__name__)
        raise
    finally:
        if rng is not None:
            rng.__exit__(None, None, None)
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


# ---------------------------------------------------------- stage timing

#: the operator's switch (`stage_timing`); ``MOSAIC_TRACE_STAGES=1`` sets
#: it once, at import
_STAGES_ON = os.environ.get("MOSAIC_TRACE_STAGES", "") == "1"


def stage_timing(on: bool) -> None:
    """Turn stage timing on or off for the process, profiler or not."""
    global _STAGES_ON
    _STAGES_ON = bool(on)


def stage_timing_on() -> bool:
    """True while a torch profiler records or the operator's switch is
    on. One flag test and, with torch loaded, one profiler-state query
    (about 0.13 µs)."""
    if _STAGES_ON:
        return True
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return torch._C._autograd._profiler_enabled()
    except AttributeError:  # torch is still being imported
        return False


def _capturing(torch) -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _open_range(name: str):
    """An entered ``record_function`` range of ``name``, or None (no
    torch, or a CUDA graph being captured)."""
    torch = sys.modules.get("torch")
    if torch is None or _capturing(torch):
        return None
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    return rng


#: open `device_stages` blocks by trace id, innermost last
_OWNERS: dict[str, list] = {}
_OWNERS_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()


class _Stage:
    """One stage span while stage timing is on (see :func:`stage_span`)."""

    __slots__ = ("name", "device", "points", "attrs", "span", "range", "marks")

    def __init__(self, name, device, points, attrs):
        self.name, self.device, self.points, self.attrs = name, device, points, attrs
        self.span = self.range = None
        self.marks: list = []

    def _mark(self) -> None:
        if self.device.type == "cuda":
            torch = sys.modules["torch"]
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def __enter__(self):
        self.span = start_span(self.name, **self.attrs)
        self.range = _open_range(self.name)
        if self.device is not None:
            self._mark()
        return self.span

    def __exit__(self, etype, exc, tb):
        if self.device is not None:
            self._mark()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        if etype is not None:
            self.span.set(error=etype.__name__)
        elif self.device is not None:
            self.span.close()
            with _OWNERS_LOCK:
                owners = _OWNERS.get(self.span.context.trace_id)
                if owners:
                    owners[-1].pending.append(self)
                    return False
        # no owner to read a device time at its sync: a plain span
        self.span.end()
        return False

    def finish(self, read: bool) -> None:
        """Record the span event; with ``read`` (the owner synced), with
        ``device_s`` and ``points``. An event pair is only polled."""
        if not read:
            self.span.end()
            return
        a, b = self.marks
        if isinstance(a, float):
            sec = b - a
        elif b.query():
            sec = a.elapsed_time(b) / 1e3
        else:
            self.span.end()
            return
        self.span.end(device_s=round(sec, 9), points=self.points)


def stage_span(name: str, *, device=None, points: int | None = None, **attrs):
    """A stage of a traced path: a child span of ``name``, with its
    profiler range, while :func:`stage_timing_on` holds; else a shared
    no-op context. With ``device`` (a ``torch.device``) the stage is
    device-timed over ``points`` points when a :func:`device_stages`
    block of its trace is open, and a plain span otherwise."""
    if not stage_timing_on():
        return _OFF
    torch = sys.modules.get("torch")
    if torch is not None and _capturing(torch):
        return _OFF
    return _Stage(name, device, points, attrs)


class _Owner:
    __slots__ = ("key", "pending")

    def __init__(self):
        self.key, self.pending = None, []

    def __enter__(self):
        ctx = current_context()
        if ctx is not None:
            self.key = ctx.trace_id
            with _OWNERS_LOCK:
                _OWNERS.setdefault(self.key, []).append(self)
        return self

    def __exit__(self, etype, exc, tb):
        if self.key is not None:
            with _OWNERS_LOCK:
                owners = _OWNERS[self.key]
                owners.remove(self)
                if not owners:
                    del _OWNERS[self.key]
        for st in self.pending:
            st.finish(read=etype is None)
        return False


def device_stages():
    """The block of a traced path that ends at its sync (the answer's
    copy back, the fold pull): the device-timed stages of the active
    span's trace opened inside are read, and their span events recorded,
    when it ends; none is read if it raises. A no-op context while
    stage timing is off."""
    return _Owner() if stage_timing_on() else _OFF


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
