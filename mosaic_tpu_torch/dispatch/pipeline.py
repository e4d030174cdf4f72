"""Pipelined execution core: bounded in-flight window + async snapshots.

Port of ``mosaic_tpu/dispatch/pipeline.py``. A strictly synchronous
segment loop pays a dispatch → block → host-pull → snapshot round trip
per segment, so the device idles while the host writes checkpoints and
the host idles while the device computes. :func:`execute_pipeline` makes
*segments* (or raster tiles) overlapped pipeline stages, written once for
every frontend (`StreamJoin.run_durable` rides it for segments,
`RasterStream.scan` for tiles):

- **launch** dispatches item i WITHOUT a host pull (CUDA launches are
  asynchronous: the returned tensors are not ready yet; no ``.cpu()``
  barrier). The frontend's launch callback owns its own
  `core.guarded_call` site, so watchdog/retry/degradation semantics are
  exactly the synchronous path's.
- **land** materializes the oldest in-flight item (the blocking pulls
  live here). The watchdog guards this *drain* point rather than each
  hop — with a window of W items, segment i's pull overlaps segments
  i+1..i+W's device compute instead of serializing after it. Because
  `runtime.watchdog.guard` ABANDONS (does not cancel) its worker
  thread on deadline, the guarded ``land`` must be side-effect-free:
  an abandoned worker may still run to completion, and any effect it
  applied would double with the replay. Effects (accumulator folds,
  output appends, snapshot submission) belong in the separate
  ``commit`` callback, which runs on the caller thread only after the
  guarded pull returned — a timed-out pull therefore commits nothing.
  A guarded ``land`` on a worker thread runs on the caller's CUDA
  device and stream (the watchdog carries them), so its pull waits for
  exactly the work the caller queued.
- **replay** is the transient-failure contract: a stall surfacing at the
  drain poisons everything in flight, so the pipeline discards the
  window and replays ``[last materialized + 1, last launched]``
  synchronously through the caller's guarded path (full retry budget +
  degradation, unchanged), then resumes pipelining. Fatal
  (non-transient) errors drain what they can and re-raise — the durable
  contract (resume from the last *completed* snapshot) is the caller's
  recovery story.

:class:`SnapshotWriter` moves checkpoint I/O off the critical path: a
background daemon thread that adopts the caller's telemetry sinks,
trace context and fault plans (the thread-local trio), and its CUDA
device and stream, then runs submitted snapshot jobs FIFO. A job's copy
of a device tensor to the host therefore waits on the writer thread,
behind the work the caller queued before it, never on the caller. A
snapshot is only durable once its job completes; jobs are ordered, so
the newest completed snapshot on disk is always a true prefix of the
run. Fatal job errors are held and re-raised on
:meth:`SnapshotWriter.flush` — a sick disk degrades durability through
the job's own ``snapshot_skipped`` handling, but a real bug still fails
the run at the next flush boundary.

The in-flight window depth resolves through :func:`resolve_window`
(``MOSAIC_STREAM_WINDOW``, default 4) at call time.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading

import torch

from ..obs import trace as _trace
from ..runtime import faults as _faults, telemetry as _telemetry
from ..runtime import watchdog as _watchdog
from ..runtime.errors import is_transient
from ..tune import resolve as _tune_resolve
from . import core as _core

__all__ = [
    "DEFAULT_WINDOW",
    "PipelineStats",
    "SnapshotWriter",
    "execute_pipeline",
    "resolve_window",
]

#: default bounded in-flight window depth (segments/tiles)
DEFAULT_WINDOW = 4


def resolve_window(window: "int | None" = None) -> int:
    """The in-flight window depth: explicit argument beats the
    ``MOSAIC_STREAM_WINDOW`` knob beats :data:`DEFAULT_WINDOW`; clamped
    to >= 1 (a window of 1 is the synchronous loop with the drain guard
    still in place). The knob is read by `tune/resolve.py`, the one
    reader of the env, which raises ``ValueError`` on a malformed value."""
    if window is None:
        window, _ = _tune_resolve.resolve_knob(
            "stream_window", None, None, DEFAULT_WINDOW
        )
    return max(1, int(window))


@dataclasses.dataclass
class PipelineStats:
    """One pipelined run's shape: the A/B evidence the bench embeds
    (``detail.pipeline``) and the tests pin."""

    window: int  #: resolved in-flight bound
    launched: int = 0  #: items dispatched (replays not re-counted)
    landed: int = 0  #: items materialized through the drain guard
    replayed: int = 0  #: items re-run synchronously after a transient
    replays: int = 0  #: transient drain/launch failures that replayed
    max_inflight: int = 0  #: high-water in-flight population

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def execute_pipeline(
    n_items: int,
    launch,
    land,
    *,
    drain_site: str,
    commit=None,
    replay=None,
    window: "int | None" = None,
    watchdog_default_s: "float | None" = None,
) -> PipelineStats:
    """Run items 0..n_items-1 through a bounded asynchronous pipeline.

    ``launch(i) -> handle`` dispatches item ``i`` (async, no host
    pull); ``land(i, handle) -> pulled`` materializes it (ordered:
    item i always lands before i+1). At most ``window`` items are in
    flight; when the window is full the oldest item is landed under
    the ``drain_site`` watchdog deadline (`runtime/watchdog.py` env
    resolution) — the drain is the pipeline's one blocking hop, so it
    is the one the watchdog guards.

    ``land`` MUST be side-effect-free: the watchdog abandons (does not
    cancel) its worker thread on deadline, so an abandoned ``land``
    may still finish after its item was replayed — any effect it
    applied would be applied twice. State mutation belongs in
    ``commit(i, pulled)``, which runs on the caller thread after the
    guarded pull returned; the replay anchor only advances once
    ``commit`` returns, so a ``commit`` that raises a transient
    replays its own item rather than skipping or double-applying it.

    A *transient* failure (``runtime.errors.is_transient``: link
    drops, typed stalls) at launch, drain, or commit discards the
    in-flight window and calls ``replay(lo, hi)`` — the caller re-runs
    items ``lo..hi`` (inclusive) synchronously from its last
    materialized carry, with its own guarded retry/degradation
    semantics — then pipelining resumes after ``hi``. With no
    ``replay`` callback the failure propagates. Non-transient errors
    drain already-launched items best-effort (completed work becomes
    durable) and re-raise.
    """
    win = resolve_window(window)
    stats = PipelineStats(window=win)
    inflight: collections.deque = collections.deque()
    # index of the last item whose effects are materialized (landed or
    # replayed) — the replay anchor
    materialized = -1

    def _replay(exc: BaseException, hi: int) -> None:
        nonlocal materialized
        if replay is None:
            raise exc
        lo = materialized + 1
        inflight.clear()
        _telemetry.record(
            "pipeline_replay", site=drain_site, lo=lo, hi=hi,
            error=repr(exc)[:200],
        )
        replay(lo, hi)
        materialized = hi
        stats.replayed += hi - lo + 1
        stats.replays += 1

    def _land_oldest() -> None:
        nonlocal materialized
        j, handle = inflight[0]
        with _trace.span(
            "stream.pipeline.drain", item=j, site=drain_site,
            inflight=len(inflight),
        ), _telemetry.timed(
            "stream_stage", stage="pipeline_drain", item=j,
            site=drain_site,
        ):
            pulled = _core.guarded_call(
                drain_site, land, j, handle,
                default_s=watchdog_default_s, retry=False,
            )
            # effects run on THIS thread, only after the guarded pull
            # returned — a deadline leaves an abandoned worker that
            # committed nothing, so the replay cannot double-apply j
            if commit is not None:
                commit(j, pulled)
        inflight.popleft()
        materialized = j
        stats.landed += 1

    i = 0
    try:
        while i < n_items or inflight:
            if inflight and (len(inflight) >= win or i >= n_items):
                try:
                    _land_oldest()
                except Exception as e:  # lint: broad-except-ok (transient drain failures replay from the last materialized carry; everything else re-raises below)
                    if not is_transient(e):
                        raise
                    _replay(e, inflight[-1][0])
                continue
            try:
                handle = launch(i)
            except Exception as e:  # lint: broad-except-ok (transient launch failures replay this item synchronously; everything else re-raises below)
                if not is_transient(e):
                    raise
                _replay(e, i)
                i += 1
                continue
            inflight.append((i, handle))
            stats.launched += 1
            stats.max_inflight = max(stats.max_inflight, len(inflight))
            i += 1
    except BaseException:
        # fatal: make already-dispatched work durable when the device
        # still answers — the resume contract replays from the last
        # COMPLETED snapshot, so every landable item narrows the gap
        while inflight:
            try:
                _land_oldest()
            except BaseException:  # noqa: BLE001 — best-effort drain; the original fatal error wins
                break
        raise
    return stats


_STOP = object()


class SnapshotWriter:
    """Background checkpoint-writer thread: snapshot I/O off the
    critical path.

    Jobs are plain callables composed by the frontend (span +
    `core.guarded_call` + its own skipped-snapshot telemetry) and run
    FIFO on one daemon worker that adopts the submitting thread's
    telemetry sinks, trace context, fault plans, and CUDA device and
    stream — so captured trails, span parentage, injected fault budgets
    and the order of device copies behave exactly as if the write ran
    inline. ``maxsize`` bounds the queue: a disk
    slower than the device back-pressures :meth:`submit` instead of
    buffering unbounded host copies.

    Failure contract: a job that raises has its exception HELD (the
    device loop must not die mid-flight for a writer error) and
    re-raised by the next :meth:`flush` — frontends flush at run end,
    so a genuinely broken writer fails the run, while expected
    degradation (sick disk) is absorbed inside the job via
    ``snapshot_skipped``. A snapshot is only durable once its job
    completed; :meth:`flush` is the durability barrier.
    """

    def __init__(self, *, name: str = "stream", maxsize: int = 8):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(maxsize)))
        self._sinks = _telemetry.current_sinks()
        self._trace = _telemetry.current_trace()
        self._plans = _faults.current_plans()
        self._cuda = _watchdog.cuda_context()
        self._error: BaseException | None = None
        self._submitted = 0
        self._completed = 0
        self._thread = threading.Thread(
            target=self._work, name=f"mosaic-snapshot-writer:{name}",
            daemon=True,
        )
        self._thread.start()

    def _work(self) -> None:
        _telemetry.adopt_sinks(self._sinks)
        _telemetry.adopt_trace(self._trace)
        _faults.adopt_plans(self._plans)
        if self._cuda is None:
            self._drain_jobs()
            return
        with torch.cuda.device(self._cuda[0]), torch.cuda.stream(self._cuda[1]):
            self._drain_jobs()

    def _drain_jobs(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                self._q.task_done()
                return
            try:
                job()
                self._completed += 1
            except BaseException as e:  # noqa: BLE001 — held, re-raised on flush() (the caller's thread)
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()

    def submit(self, job) -> None:
        """Enqueue one snapshot job (blocks when the queue is full —
        the writer's back-pressure). Raises the held error of an
        earlier job instead of accepting more work after a failure."""
        self._raise_held()
        if not self._thread.is_alive():
            raise RuntimeError("snapshot writer is closed")
        self._q.put(job)
        self._submitted += 1

    def flush(self) -> None:
        """Block until every submitted job completed — the durability
        barrier (a snapshot exists on disk only after its job ran) —
        then re-raise the first held job error, if any."""
        self._q.join()
        self._raise_held()

    def close(self, *, flush: bool = True) -> None:
        """Stop the worker. With ``flush`` (default) this is a
        durability barrier first; ``flush=False`` abandons queued jobs
        (fatal-error unwind — the original exception wins)."""
        if flush and self._thread.is_alive():
            self._q.join()
        if self._thread.is_alive():
            if not flush:
                # abandon for real: pull queued jobs off the queue so
                # the STOP marker isn't FIFO-ordered behind them (and
                # so put() below cannot block on a full queue). Best
                # effort — a job the worker already grabbed still runs.
                while True:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        break
                    self._submitted -= 1
                    self._q.task_done()
            self._q.put(_STOP)
            self._thread.join()
        if flush:
            self._raise_held()

    def _raise_held(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @property
    def pending(self) -> int:
        """Jobs submitted but not yet completed."""
        return self._submitted - self._completed
