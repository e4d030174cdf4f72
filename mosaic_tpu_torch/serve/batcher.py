"""Dynamic micro-batching: many small requests -> one well-shaped device
dispatch.

Port of ``mosaic_tpu/serve/batcher.py``, unchanged in policy. The
batcher thread never touches the device itself: the engine's dispatch
function runs on the dispatch core, which makes the index's device
current for each dispatch (`dispatch/core.py`), so the thread's own
current device is never relied on.

The batching policy is the classic (max batch size, max wait window)
pair: the worker takes the oldest queued request, then keeps coalescing
while the summed rows stay within ``max_batch_rows`` AND the window
(``max_wait_s``, counted from the FIRST request in the batch) has not
expired. A request that would overshoot the row budget goes back to the
queue head and leads the next batch — requests are never split, so each
request's rows are contiguous in the concatenated batch and scatter-back
is one slice per request.

Correctness contract (pinned by tests/test_torch_serve.py): co-batched results
are BIT-IDENTICAL to solo execution. This is structural, not
approximate — cell assignment is pointwise, the probe evaluates each row
independently, and caps at the full bucket cannot overflow — so
coalescing changes scheduling, never values.

Deadline enforcement happens at the two batcher touchpoints:

- **formation**: a request already past its deadline is shed before any
  device work is spent on it (``Overloaded(reason="deadline")``);
- **scatter-back**: after the dispatch returns (possibly delayed by a
  stall the watchdog/retry stack absorbed), each request's deadline is
  re-checked; late requests are shed — and ONLY they: batchmates with
  remaining budget keep their results. A stall therefore degrades the
  engine request-by-request, never batch-by-batch.

``serve.batch`` is the batch-formation fault site; the dispatch itself
runs under the ``serve.dispatch`` watchdog/fault site inside the
engine's dispatch function.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..obs import trace as _trace
from ..runtime import faults as _faults, telemetry as _telemetry
from ..runtime.errors import DegradedResult, Overloaded
from .admission import AdmissionController, Request


class MicroBatcher:
    """Background coalescing loop over an :class:`AdmissionController`.

    ``dispatch(points, deadline_hint, reqs)`` is the engine-supplied
    function mapping a concatenated ``(n, 2)`` f64 array to
    ``(results, occupancy)`` (padding, bucketing, retry, and degradation
    live there; the hint — the batch's largest remaining request budget
    in seconds — becomes the watchdog default; ``reqs`` is the live
    request list in concatenation order, which lets the engine split a
    mixed point-in-polygon/KNN batch by ``Request.kind`` and answer each
    segment in its own wire shape). The result only needs
    ``out[off : off + n]`` slicing at the request boundaries — a plain
    (n,) array for uniform batches, the engine's segment view for mixed
    ones. The batcher owns request lifecycle: coalescing, deadline
    shedding, scatter-back, and future resolution.
    """

    def __init__(
        self,
        admission: AdmissionController,
        dispatch,
        *,
        max_batch_rows: int = 16384,
        max_wait_s: float = 0.002,
        idle_tick_s: float = 0.05,
    ):
        self.admission = admission
        self.dispatch = dispatch
        self.max_batch_rows = int(max_batch_rows)
        self.max_wait_s = float(max_wait_s)
        self.idle_tick_s = float(idle_tick_s)
        self.metrics = {
            "batches": 0,
            "batched_rows": 0,
            "batched_requests": 0,
            "shed_deadline": 0,
            "completed": 0,
            "failed": 0,
            "degraded": 0,
            "occupancy_sum": 0.0,
        }
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mosaic-serve-batcher", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        for req in self.admission.drain():
            self._shed(req, "shutdown")

    # ------------------------------------------------------------ loop

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = self.admission.take(self.idle_tick_s)
            if first is None:
                continue
            batch = self._form_batch(first)
            if batch:
                self._process(batch)

    def _form_batch(self, first: Request) -> list[Request]:
        """Coalesce from the queue until the row budget or the window
        (measured from ``first``'s arrival at the batcher) is spent."""
        batch = [first]
        rows = first.n
        window_end = time.monotonic() + self.max_wait_s
        while rows < self.max_batch_rows:
            remaining = window_end - time.monotonic()
            if remaining <= 0:
                break
            nxt = self.admission.take(remaining)
            if nxt is None:
                break
            if rows + nxt.n > self.max_batch_rows:
                self.admission.put_back(nxt)
                break
            batch.append(nxt)
            rows += nxt.n
        return batch

    def _process(self, batch: list[Request]) -> None:
        # the dispatch worker adopts the FIRST request's caller context:
        # fault plans, capture sinks, and span context are thread-local,
        # and tests install them on the submitting thread (batchmates
        # from other traces keep their OWN root spans; only the shared
        # batch/dispatch spans parent to the first request's trace)
        _telemetry.adopt_sinks(batch[0].sinks)
        _faults.adopt_plans(batch[0].plans)
        _trace.adopt_context(batch[0].ctx)

        now = time.monotonic()
        live = []
        for req in batch:
            if req.remaining(now) <= 0:
                self._shed(req, "deadline")
            else:
                live.append(req)
        if not live:
            return

        # queue-wait interval per admitted request: submit stamp →
        # batch formation (this instant); recorded flat (ts_mono -
        # seconds recovers the interval) and stamped with the request's
        # own trace ids so the wait lands inside its serve.request root
        for req in live:
            _telemetry.record(
                "serve_stage", stage="queue_wait",
                seconds=round(max(now - req.t_submit, 0.0), 6),
                rows=req.n, **_req_ids(req),
            )

        rows = sum(r.n for r in live)
        self.metrics["batches"] += 1
        self.metrics["batched_rows"] += rows
        self.metrics["batched_requests"] += len(live)
        try:
            with _trace.span(
                "serve.batch", requests=len(live), rows=rows,
            ), _telemetry.timed(
                "serve_stage", stage="batch", requests=len(live), rows=rows,
            ):
                _faults.maybe_fail("serve.batch")
                points = (
                    live[0].points
                    if len(live) == 1
                    else np.concatenate([r.points for r in live])
                )
                # the watchdog default for this dispatch: the batch's
                # largest remaining request budget (None = no deadline)
                rem = [r.remaining(now) for r in live]
                hint = max(rem) if all(np.isfinite(rem)) else None
                out, occupancy = self.dispatch(points, hint, live)
            self.metrics["occupancy_sum"] += float(occupancy)
        except BaseException as e:  # noqa: BLE001 — delivered per-future
            for req in live:
                self._fail(req, e)
            return

        # mixed-batch segment views flag degradation via a plain
        # attribute (they are not ndarray subclasses)
        degraded = isinstance(out, DegradedResult) or bool(
            getattr(out, "degraded", False)
        )
        now = time.monotonic()
        off = 0
        for req in live:
            sl = np.asarray(out[off : off + req.n])
            off += req.n
            if req.remaining(now) <= 0:
                self._shed(req, "deadline")
                continue
            if degraded:
                sl = DegradedResult.wrap(
                    sl, reason=out.reason, attempts=out.attempts
                )
                self.metrics["degraded"] += 1
            self.metrics["completed"] += 1
            # the event and the root-span close both carry the REQUEST's
            # own trace ids — the ambient context here is batch[0]'s
            _telemetry.record(
                "serve_request",
                seconds=round(now - req.t_submit, 6),
                rows=req.n,
                parked=req.parked,
                degraded=bool(degraded),
                **_req_ids(req),
            )
            if req.span is not None:
                req.span.end(degraded=bool(degraded), parked=req.parked)
            req.future.set_result(sl)

    def _shed(self, req: Request, reason: str) -> None:
        self.metrics["shed_deadline"] += reason == "deadline"
        elapsed = time.monotonic() - req.t_submit
        _telemetry.record(
            "serve_shed", reason=reason, rows=req.n,
            elapsed_s=round(elapsed, 6),
            **_req_ids(req),
        )
        if req.span is not None:
            req.span.end(error="Overloaded", reason=reason)
        req.future.set_exception(
            Overloaded(
                f"request shed ({reason}) after {elapsed:.3f}s",
                reason=reason,
                elapsed_s=elapsed,
                deadline_s=(
                    0.0
                    if req.deadline is None
                    else req.deadline - req.t_submit
                ),
            )
        )

    def _fail(self, req: Request, exc: BaseException) -> None:
        self.metrics["failed"] += 1
        if req.span is not None:
            req.span.end(error=type(exc).__name__)
        req.future.set_exception(exc)


def _req_ids(req: Request) -> dict:
    """Explicit trace stamps for per-request events recorded while the
    thread's ambient context belongs to another batchmate."""
    if req.ctx is None:
        return {}
    return {"trace_id": req.ctx.trace_id, "span_id": req.ctx.span_id}
