"""Admission control: bounded queue, per-request deadlines, poison
diversion — load never turns into unbounded memory, unbounded latency,
or a corrupted shared batch.

Port of ``mosaic_tpu/serve/admission.py``: point-in-polygon and KNN
requests share one queue (``Request.kind``). Three decisions happen at
the submit boundary, in order:

1. **Fault hooks** — ``serve.admit`` is a fault-injection site:
   `runtime/faults.maybe_fail` can raise a synthetic transient here and
   `maybe_corrupt` can poison the request's rows.
2. **Quarantine** — rows that are non-finite or outside the declared
   domain bounds are *parked* (`runtime/quarantine.py`): replaced by a
   coordinate proven to hit no indexed cell, so they answer -1 without
   special-casing the kernel and cannot perturb batchmates.
3. **Backpressure** — the queue is bounded. At capacity the request is
   REFUSED with a typed :class:`~mosaic_tpu_torch.runtime.errors.
   Overloaded` (``reason="queue_full"``) instead of queueing.

What differs from the reference: the queue's capacity is checked once
when the request arrives as well as under the queue's lock. A request
refused at a full queue on arrival is neither scrubbed nor traced (no
``serve.request`` span; its ``serve_shed`` event and ``Overloaded`` are
the reference's), and the refusal yields the GIL once. A refusal then
costs a fraction of an admission and a flooding caller's thread never
holds the GIL through a burst of them: every engine's eager dispatch
releases and retakes the GIL at each of its several hundred ops, so a
burst of Python on another thread delays each op (PERF.md §5-6).

Deadlines are stamped here (monotonic clock) and enforced by the batcher
at batch formation and at scatter-back.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..obs import metrics as _metrics, trace as _trace
from ..runtime import (
    faults as _faults,
    quarantine as _quarantine,
    telemetry as _telemetry,
)
from ..runtime.errors import Overloaded


@dataclasses.dataclass
class Request:
    """One admitted request queued for dispatch."""

    points: np.ndarray  # (n, 2) f64, poison rows already parked
    future: Future
    n: int
    t_submit: float  # monotonic
    deadline: float | None  # monotonic instant, None = no deadline
    parked: int = 0  # rows diverted to quarantine
    quarantine: "_quarantine.QuarantineReport | None" = None
    #: caller-thread context the dispatch worker adopts (both are
    #: thread-local in their modules)
    sinks: list = dataclasses.field(default_factory=list)
    plans: list = dataclasses.field(default_factory=list)
    #: the request's trace — ``span`` is the ``serve.request`` root
    #: (begun at admission, ended at scatter-back/shed), ``ctx`` its
    #: context, which the batcher thread adopts
    span: "_trace.Span | None" = None
    ctx: "_trace.SpanContext | None" = None
    #: request family sharing this queue: "pip" ((n,) int32 answers) or
    #: "knn" ((n, 2k) f64 wire rows) — one admission/deadline/shed budget
    #: covers both, the engine's dispatch splits a mixed batch by kind
    kind: str = "pip"
    k: int = 0  # neighbour count, kind == "knn" only

    def remaining(self, now: float | None = None) -> float:
        if self.deadline is None:
            return float("inf")
        return self.deadline - (time.monotonic() if now is None else now)


class AdmissionController:
    """Bounded request queue with deadline stamping and poison parking.

    ``capacity`` bounds QUEUED requests; ``default_deadline_s`` applies
    when a submit passes none; ``bounds`` is the (xmin, ymin, xmax, ymax)
    valid domain for quarantine scrubbing (None: non-finite rows only).
    ``park_point`` short-circuits the park search; otherwise the first
    poisoned admit derives one from ``find_park`` (the engine wires the
    index-aware search in).
    """

    def __init__(
        self,
        *,
        capacity: int = 256,
        default_deadline_s: float | None = None,
        bounds: tuple | None = None,
        park_point: np.ndarray | None = None,
        find_park=None,
    ):
        self.capacity = int(capacity)
        self.default_deadline_s = default_deadline_s
        self.bounds = bounds
        self._park = (
            None
            if park_point is None
            else np.asarray(park_point, dtype=np.float64)
        )
        self._find_park = find_park
        self._queue: list[Request] = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.metrics = {
            "submitted": 0,
            "admitted": 0,
            "shed_queue_full": 0,
            "quarantined_rows": 0,
            "poisoned_requests": 0,
        }

    # ------------------------------------------------------ submit side

    def admit(
        self,
        points: np.ndarray,
        *,
        deadline_s: float | None = None,
        kind: str = "pip",
        k: int = 0,
    ) -> Request:
        """Scrub, stamp, and enqueue one request; returns it with its
        future. Raises :class:`Overloaded` when the queue is full.
        ``kind``/``k`` route the request family (KNN requests co-batch
        with point-in-polygon traffic under this same queue, deadline
        budget and shed taxonomy)."""
        _faults.maybe_fail("serve.admit")
        raw = np.asarray(
            _faults.maybe_corrupt("serve.admit", points), dtype=np.float64
        )
        if raw.ndim != 2 or raw.shape[1] != 2:
            raise ValueError(f"expected (n, 2) points, got {raw.shape}")
        self.metrics["submitted"] += 1
        if len(self._queue) >= self.capacity:
            # full before any work: refuse cheaply, and yield the GIL
            # once, so a caller flooding a full queue cannot hold it
            # through a burst of refusals while an engine's dispatch
            # waits to take it back after each of its eager ops
            time.sleep(0)
            self._refuse()

        # the request's trace root: begun here on the submit thread,
        # ended at scatter-back (or shed) on the batcher thread
        root = _trace.start_span(
            "serve.request", detached=True, rows=int(raw.shape[0]),
            kind=kind,
        )
        try:
            with _trace.span(
                "serve.admit", parent=root.context, rows=int(raw.shape[0]),
            ):
                return self._admit_scrubbed(raw, deadline_s, root, kind, k)
        except BaseException as e:  # noqa: BLE001 — span closed, re-raised
            root.end(error=type(e).__name__)
            raise

    def _admit_scrubbed(
        self, raw: np.ndarray, deadline_s: float | None, root,
        kind: str = "pip", k: int = 0,
    ) -> Request:
        report = None
        parked = 0
        bad, reasons = _quarantine.scrub_points(raw, bounds=self.bounds)
        if bad.any():
            report = _quarantine.QuarantineReport()
            report.merge_batch(0, raw, bad, reasons)
            clean = raw.copy()
            clean[bad] = self._park_point(raw)
            parked = int(bad.sum())
            self.metrics["quarantined_rows"] += parked
            self.metrics["poisoned_requests"] += 1
            _telemetry.record(
                "serve_quarantine", rows=parked, of=int(raw.shape[0]),
                reasons={k: v for k, v in reasons.items() if v},
            )
            raw = clean

        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        req = Request(
            points=raw,
            future=Future(),
            n=int(raw.shape[0]),
            t_submit=now,
            deadline=None if deadline_s is None else now + float(deadline_s),
            parked=parked,
            quarantine=report,
            sinks=_telemetry.current_sinks(),
            plans=_faults.current_plans(),
            span=root,
            ctx=root.context,
            kind=kind,
            k=int(k),
        )
        with self._not_empty:
            if len(self._queue) >= self.capacity:
                self._refuse()
            self._queue.append(req)
            self.metrics["admitted"] += 1
            _metrics.gauge("serve.queue_depth").set(len(self._queue))
            self._not_empty.notify()
        return req

    def _refuse(self) -> None:
        """Shed at admission: the queue is full."""
        depth = len(self._queue)
        self.metrics["shed_queue_full"] += 1
        _telemetry.record(
            "serve_shed", reason="queue_full", queue_depth=depth,
            capacity=self.capacity,
        )
        raise Overloaded(
            f"serve queue full ({depth}/{self.capacity} requests) "
            f"— shedding at admission",
            reason="queue_full",
            queue_depth=depth,
            capacity=self.capacity,
        )

    def _park_point(self, raw: np.ndarray) -> np.ndarray:
        if self._park is None:
            if self._find_park is None:
                raise ValueError(
                    "admission needs a park_point or find_park to divert "
                    "poisoned rows"
                )
            self._park = np.asarray(
                self._find_park(raw), dtype=np.float64
            )
        return self._park

    # ---------------------------------------------------- consumer side

    def take(self, timeout: float | None) -> Request | None:
        """Pop the oldest request, waiting up to ``timeout``; None on
        timeout (the batcher's idle tick)."""
        with self._not_empty:
            if not self._queue:
                self._not_empty.wait(timeout)
            if not self._queue:
                return None
            req = self._queue.pop(0)
            _metrics.gauge("serve.queue_depth").set(len(self._queue))
            return req

    def put_back(self, req: Request) -> None:
        """Return a request to the queue HEAD (the batcher overshot its
        row budget — this request leads the next batch)."""
        with self._not_empty:
            self._queue.insert(0, req)
            self._not_empty.notify()

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def drain(self) -> list[Request]:
        """Remove and return every queued request (shutdown path)."""
        with self._lock:
            out, self._queue = self._queue, []
            return out
