"""The request lifecycle: submit -> future -> padded, shape-bucketed
device dispatch with the runtime's resilience wired in.

Port of ``mosaic_tpu/serve/engine.py``. One :class:`ServeEngine` owns a
resident :class:`~mosaic_tpu_torch.sql.join.ChipIndex` and turns
concurrent point-in-polygon requests into micro-batched dispatches on the
dispatch core (`mosaic_tpu_torch/dispatch`). The pipeline per batch:

    admit (quarantine + backpressure, `serve/admission.py`)
      -> coalesce (max-batch / max-wait window, `serve/batcher.py`)
      -> pad to bucket + execute through `dispatch.DispatchCore` under
         the ``serve.dispatch`` watchdog/fault site and transient retry
      -> scatter back per request, shedding only deadline-expired ones

- `runtime/faults.py` sites ``serve.admit`` / ``serve.batch`` /
  ``serve.dispatch`` make every failure mode injectable from tests.
- every stage emits ``serve_stage`` `telemetry.timed` events; per-request
  latency lands in ``serve_request`` events (`telemetry.summarize` turns
  them into p50/p99).

Signature discipline is the core's: caps fixed at the full bucket, one
signature per (bucket, index), :meth:`warmup` running every rung. After
warmup the signature set is frozen — a dispatch introducing a new
signature emits a ``serve_compile`` event and counts in
``metrics()["cold_compiles"]``.

What differs from the reference, and why:

- the engine runs on its index's device (the card unless the index was
  built with ``device="cpu"``); answers equal the port's
  ``pip_join(recheck=False)`` bit for bit, cells in float32 unless
  ``cell_dtype`` says otherwise;
- past the retry budget only an engine on the CPU degrades to the f64
  host oracle (`DegradedResult`); on the card the batch's futures raise
  `RetryExhausted` and no work moves to the CPU — KNN batches included
  (`knn/frontend.py`);
- ``program_store=`` (or ``MOSAIC_PROGRAM_STORE``) binds the program
  store (`dispatch/programs.py`) as the reference's does: the core, a
  hot swap's new core and the KNN frontend built from a ``knn=`` index
  share it, and ``warmup()`` reports its ``"aot"`` counts; a store-warmed
  engine binds its kernel library without nvcc. ``mesh=`` (or the
  ``MOSAIC_MESH`` knob) places every dispatch data parallel over a
  `parallel.mesh.Mesh` with the index replicated, as the reference's:
  the answers are the single-device bits, a hot swap keeps the mesh, and
  the KNN frontend built from a ``knn=`` index shares it;
- ``profile=`` and ``hot_swap(profile=)`` resolve as the reference's;
  ``hot_swap`` frees the replaced core's CUDA graphs, every shard's (see
  :meth:`ServeEngine.hot_swap`).

KNN requests (``knn=`` a :class:`~mosaic_tpu_torch.knn.KNNIndex` or a
ready :class:`~mosaic_tpu_torch.knn.KNNFrontend`, ``submit_knn``) ride
the same admission queue, deadline budget, micro-batch window and shed
taxonomy; a mixed batch is split by request kind (:meth:`ServeEngine.
_dispatch_mixed`) and each family keeps its exact answers.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np
import torch

from ..dispatch import BucketLadder, DispatchCore, cells_prog, resolve_program_store
from ..obs import trace as _trace
from ..runtime import quarantine as _quarantine, telemetry as _telemetry
from ..runtime.errors import DegradedResult
from ..tune.resolve import resolve_knobs
from .admission import AdmissionController
from .batcher import MicroBatcher


def _profile_ladder(knobs: dict) -> "BucketLadder | None":
    """The ladder a resolved ``bucket_min``/``bucket_max`` pair asks for
    (an unset end keeps the built-in 64 or 65,536), or None when neither
    is set."""
    if not (knobs["bucket_min"] or knobs["bucket_max"]):
        return None
    return BucketLadder(
        min_bucket=int(knobs["bucket_min"] or 64),
        max_bucket=int(knobs["bucket_max"] or 65536),
    )


class _MixedOut:
    """Result view of a mixed-kind batch: per-request answer segments
    keyed by their ``(start, stop)`` row interval in the concatenated
    batch. Requests are never split across batches, so the batcher's
    scatter-back slices ``out[off : off + req.n]`` land exactly on these
    keys — each request reads its own wire shape ((n,) int32 for PIP,
    (n, 2k) f64 for KNN).

    ``degraded`` is batch-level and conservative: if ANY segment fell
    back to the host oracle (on the CPU), every request in the batch is
    flagged (values are exact either way)."""

    def __init__(self, segments, *, degraded=False, reason=None, attempts=0):
        self._segments = segments
        self.degraded = bool(degraded)
        self.reason = reason
        self.attempts = attempts

    def __getitem__(self, sl: slice):
        seg = self._segments.get((sl.start, sl.stop))
        if seg is None:
            raise KeyError(f"no batch segment at rows [{sl.start}, {sl.stop})")
        return seg


class ServeEngine:
    """Online serving engine over a resident chip index.

    >>> engine = ServeEngine(index, h3, 9, bounds=bbox)
    >>> engine.warmup()
    >>> fut = engine.submit(points)          # (n, 2) -> Future
    >>> rows = fut.result(timeout=1.0)       # (n,) int32, -1 = no match
    """

    def __init__(
        self,
        index,
        index_system,
        resolution: int,
        *,
        ladder: BucketLadder | None = None,
        max_batch_rows: int | None = None,
        max_wait_s: float = 0.002,
        queue_capacity: int = 256,
        default_deadline_s: float | None = 1.0,
        bounds: tuple | None = None,
        park_point: np.ndarray | None = None,
        writeback: str | None = None,
        lookup: str | None = None,
        cell_dtype=None,
        watchdog_grace_s: float = 0.5,
        probe: str | None = None,
        mesh=None,
        profile=None,
        program_store=None,
        knn=None,
        knn_lane: str | None = None,
    ):
        self.index = index
        self.index_system = index_system
        self.resolution = index_system.resolution_arg(resolution)
        # profile-consumed knobs resolve HERE, at the host entry point,
        # with the one documented precedence: explicit arg > env knob >
        # TuningProfile > built-in default (tune/resolve.py)
        knobs = resolve_knobs(
            "serve_engine", profile,
            explicit={
                "probe": probe, "writeback": writeback, "lookup": lookup,
                "bucket_min": None, "bucket_max": None,
                "knn_lane": knn_lane,
            },
            defaults={
                "probe": "scatter", "writeback": "scatter", "lookup": None,
                "bucket_min": None, "bucket_max": None,
                "knn_lane": None,
            },
        )
        self.ladder = ladder or _profile_ladder(knobs) or BucketLadder()
        self.writeback = knobs["writeback"]
        self.cell_dtype = cell_dtype
        self.watchdog_grace_s = float(watchdog_grace_s)
        # a hot_swap rebinds (ladder, core, index) as one unit; the lock
        # only guards the rebind and the dispatch-side snapshot of the
        # pair, never the dispatch itself
        self._swap_lock = threading.Lock()
        # batches in flight on each core (the batcher's snapshots): a core
        # a hot_swap replaced frees its CUDA graphs when its last one ends
        self._holds: dict = {}
        # the core owns probe/lookup resolution, caps, signature
        # accounting, the guarded execute path and (with a store bound:
        # explicit arg or MOSAIC_PROGRAM_STORE) the program store that
        # makes warmup a load, not a build
        self.program_store = resolve_program_store(program_store)
        self.core = DispatchCore(
            index, index_system, resolution, ladder=self.ladder,
            writeback=self.writeback, lookup=knobs["lookup"],
            probe=knobs["probe"], cell_dtype=cell_dtype, mesh=mesh,
            on_cold_compile=self._on_cold_compile,
            program_store=self.program_store,
        )
        self.probe = self.core.probe
        self.lookup = self.core.lookup
        self.mesh = self.core.mesh
        # optional KNN frontend riding the same queue and batcher: a
        # KNNIndex builds a fresh frontend sharing the engine's mesh,
        # program store and cold-compile tripwire; a KNNFrontend is
        # adopted as it is
        self.knn_lane = knobs["knn_lane"]
        self.knn = self._build_knn(knn, self.knn_lane)
        self.admission = AdmissionController(
            capacity=queue_capacity,
            default_deadline_s=default_deadline_s,
            bounds=bounds,
            park_point=park_point,
            find_park=self._derive_park,
        )
        self.batcher = MicroBatcher(
            self.admission,
            self._dispatch,
            max_batch_rows=(
                min(self.ladder.max_bucket, 16384)
                if max_batch_rows is None
                else int(max_batch_rows)
            ),
            max_wait_s=max_wait_s,
        )
        if self.batcher.max_batch_rows > self.ladder.max_bucket:
            raise ValueError(
                f"max_batch_rows {self.batcher.max_batch_rows} exceeds the "
                f"top bucket {self.ladder.max_bucket}"
            )
        self._closed = False
        self.batcher.start()

    # ----------------------------------------------------------- public

    def submit(self, points, *, deadline_s: float | None = None):
        """Enqueue one request; returns its ``concurrent.futures.Future``
        resolving to the (n,) int32 matches (:class:`Overloaded` when
        shed). Raises :class:`Overloaded` at admission when the queue is
        full."""
        if self._closed:
            raise RuntimeError("engine is closed")
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"expected (n, 2) points, got {pts.shape}")
        if pts.shape[0] > self.ladder.max_bucket:
            raise ValueError(
                f"request of {pts.shape[0]} rows exceeds the top bucket "
                f"{self.ladder.max_bucket} — split it upstream"
            )
        return self.admission.admit(pts, deadline_s=deadline_s).future

    def join(self, points, *, deadline_s: float | None = None, timeout=None):
        """Synchronous convenience wrapper: submit and wait."""
        return self.submit(points, deadline_s=deadline_s).result(timeout)

    def submit_knn(self, points, k: int, *, deadline_s: float | None = None):
        """Enqueue one k-nearest-neighbour request; returns a Future
        resolving to a :class:`~mosaic_tpu_torch.knn.KNNAnswer` with
        (n, k) ``ids``/``distance`` arrays (:class:`Overloaded` when
        shed). KNN requests ride the same admission queue, deadline
        budget, micro-batch window and shed taxonomy as point-in-polygon
        traffic. Quarantined (non-finite / out-of-bounds) rows answer
        ``ids=-1, distance=inf``."""
        if self._closed:
            raise RuntimeError("engine is closed")
        if self.knn is None:
            raise RuntimeError(
                "engine has no KNN frontend — pass knn= at construction "
                "or hot_swap(knn=...)"
            )
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        pts = np.asarray(points, dtype=np.float64)
        if pts.ndim != 2 or pts.shape[1] != 2:
            raise ValueError(f"expected (n, 2) points, got {pts.shape}")
        if pts.shape[0] > self.ladder.max_bucket:
            raise ValueError(
                f"request of {pts.shape[0]} rows exceeds the top bucket "
                f"{self.ladder.max_bucket} — split it upstream"
            )
        req = self.admission.admit(pts, deadline_s=deadline_s, kind="knn", k=k)
        return _decode_knn_future(req, k)

    def join_knn(
        self, points, k: int, *, deadline_s: float | None = None, timeout=None
    ):
        """Synchronous convenience wrapper: submit_knn and wait."""
        return self.submit_knn(points, k, deadline_s=deadline_s).result(
            timeout
        )

    def warmup(self) -> dict:
        """Run every ladder bucket once against the resident index.

        Binds the kernel library the probe launches and runs the exact
        dispatch path (cell assignment + probe) on an inert full-bucket
        batch per rung, so the first real request at any admitted shape
        finds the library bound and the allocator primed. Returns
        ``{"buckets", "seconds", "signatures", "backend_compiles"}``
        (nvcc builds started) and ``"rung_seconds"``, ``"aot"`` (the
        program store's loads, exports and fallbacks) when a store is
        bound, and ``"knn"`` (the frontend's warmup) when the engine
        serves KNN; after this, any
        dispatch that still introduces a new signature is counted in
        ``metrics()["cold_compiles"]`` (and emits ``serve_compile``)."""
        from ..dispatch import backend_compiles

        t0 = backend_compiles()
        with _telemetry.capture() as events, _trace.span(
            "serve.warmup", buckets=len(self.ladder.buckets)
        ):
            self.core.load_kernels()
            for b in self.ladder.buckets:
                pts = np.zeros((b, 2), dtype=np.float64)
                with _telemetry.timed(
                    "serve_stage", stage="warmup", bucket=b
                ):
                    self.core.execute_padded(pts)
            knn_stats = self.knn.warmup() if self.knn is not None else None
        rungs = {
            e["bucket"]: e["seconds"]
            for e in events
            if e.get("stage") == "warmup" and "seconds" in e
        }
        self.core.freeze()
        out = {
            "buckets": len(self.ladder.buckets),
            "seconds": round(sum(rungs.values()), 4),
            "signatures": len(self.core.signatures),
            "backend_compiles": backend_compiles() - t0,
            "rung_seconds": rungs,
        }
        if self.program_store is not None:
            out["aot"] = dict(self.core.aot_stats)
        if knn_stats is not None:
            out["knn"] = knn_stats
        # the event keys rungs by string, as JSON does: a trail written
        # and read back equals the live event
        _telemetry.record("serve_warmup", **dict(
            out, rung_seconds={str(b): s for b, s in rungs.items()}))
        return out

    def hot_swap(
        self,
        index=None,
        *,
        profile=None,
        resolution: int | None = None,
        probe: str | None = None,
        writeback: str | None = None,
        lookup: str | None = None,
        ladder: BucketLadder | None = None,
        knn=None,
        knn_lane: str | None = None,
    ) -> dict:
        """Swap in a new index and/or `TuningProfile` without dropping the
        engine: a NEW dispatch core is built off to the side, its ladder
        rungs run and its signature set frozen (`DispatchCore.warmup`),
        and only then is ``(ladder, core, index)`` rebound as one unit —
        requests in flight finish on the old core, requests after the
        swap run on the warmed new one. The old core's CUDA graphs are
        freed once no batch is in flight on it: here when none is, else by
        the batch that ends last (:meth:`_dispatch`), never later by a
        garbage collection. Any post-swap dispatch that still introduces
        a signature counts in ``metrics()["cold_compiles"]``. Knob
        precedence matches the constructor (explicit > env > profile >
        default), with the engine's CURRENT settings as the defaults: a
        profile-less ``hot_swap(index)`` swaps the index and keeps the
        tuning. A profile's ``resolution`` becomes the engine's, so a
        caller swapping in an index built at another resolution passes
        ``resolution=`` (`EpochalIndex.publish` does). A new ``knn=``
        swaps the same way: its frontend is built and warmed off to the
        side and rebound with the core (a batch in flight holds its
        snapshot). Returns the new core's warmup stats (``"knn"``: the
        new frontend's)."""
        index = self.index if index is None else index
        knobs = resolve_knobs(
            "serve_engine.hot_swap", profile,
            explicit={
                "resolution": resolution,
                "probe": probe, "writeback": writeback, "lookup": lookup,
                "bucket_min": None, "bucket_max": None,
            },
            defaults={
                "resolution": self.resolution,
                "probe": self.core.probe, "writeback": self.writeback,
                "lookup": self.core.lookup,
                "bucket_min": None, "bucket_max": None,
            },
        )
        new_resolution = self.index_system.resolution_arg(knobs["resolution"])
        ladder = ladder or _profile_ladder(knobs) or self.ladder
        new_writeback = knobs["writeback"]
        with _trace.span(
            "serve.hot_swap", buckets=len(ladder.buckets),
            profiled=profile is not None,
        ), _telemetry.timed("serve_stage", stage="hot_swap"):
            core = DispatchCore(
                index, self.index_system, new_resolution, ladder=ladder,
                writeback=new_writeback, lookup=knobs["lookup"],
                probe=knobs["probe"], cell_dtype=self.cell_dtype,
                mesh=self.mesh, on_cold_compile=self._on_cold_compile,
                program_store=self.program_store,
            )
            stats = core.warmup()  # runs every rung, then freezes
            new_knn = self.knn
            if knn is not None:
                new_knn = self._build_knn(knn, knn_lane or self.knn_lane)
                stats["knn"] = new_knn.warmup()
            with self._swap_lock:
                old = self.core
                self.index = index
                self.resolution = new_resolution
                self.ladder = ladder
                self.core = core
                self.knn = new_knn
                self.writeback = new_writeback
                self.probe = core.probe
                self.lookup = core.lookup
                # keep the coalescing window inside the new ladder's span
                self.batcher.max_batch_rows = min(
                    self.batcher.max_batch_rows, ladder.max_bucket
                )
                busy = old in self._holds
            if not busy:
                old.release_graphs()
        _telemetry.record("serve_swap", **stats)
        return stats

    def metrics(self) -> dict:
        a, b = self.admission.metrics, self.batcher.metrics
        out = dict(a)
        out.update(b)
        out["shed"] = a["shed_queue_full"] + b["shed_deadline"]
        out["quarantined"] = a["quarantined_rows"]
        out["queue_depth"] = self.admission.depth()
        out["compile_signatures"] = len(self.core.signatures)
        out["cold_compiles"] = self.core.cold_compiles
        if self.knn is not None:
            out.update(self.knn.metrics())
            out["cold_compiles"] += self.knn.cold_compiles
        out["occupancy_mean"] = round(
            b["occupancy_sum"] / b["batches"], 4
        ) if b["batches"] else 0.0
        return out

    def close(self, timeout: float = 5.0) -> None:
        """Stop the batcher; queued requests are shed
        (``reason="shutdown"``); the core's CUDA graphs are freed at once
        (`DispatchCore.release_graphs`), or by a batch still in flight
        when it ends."""
        if not self._closed:
            self._closed = True
            self.batcher.stop(timeout)
            with self._swap_lock:
                busy = self.core in self._holds
            if not busy:
                self.core.release_graphs()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- dispatch

    def _build_knn(self, knn, lane):
        """Wrap a KNNIndex in a frontend sharing the engine's mesh,
        program store and cold-compile tripwire; pass a ready-made
        frontend through unchanged; None stays None."""
        if knn is None:
            return None
        from ..knn.frontend import KNNFrontend
        from ..knn.index import KNNIndex

        if isinstance(knn, KNNFrontend):
            return knn
        if not isinstance(knn, KNNIndex):
            raise TypeError(
                f"knn= takes a KNNIndex or a KNNFrontend, got {type(knn).__name__}"
            )
        return KNNFrontend(
            knn, lane=lane or "ring", mesh=self.mesh,
            program_store=self.program_store,
            on_cold_compile=self._on_cold_compile,
        )

    def _dispatch(self, points: np.ndarray, deadline_hint=None, reqs=None):
        """Batcher callback: pad, dispatch with resilience, unpad.
        Returns ``(results, occupancy)`` — a plain (n,) array for a
        uniform point-in-polygon batch, a :class:`_MixedOut` segment view
        when the batch carries KNN requests."""
        # snapshot the swap unit so a concurrent hot_swap can never pad
        # with one ladder and execute on the other core; the hold keeps
        # the core's graphs until this batch is done with them
        with self._swap_lock:
            ladder, core, knn = self.ladder, self.core, self.knn
            self._holds[core] = self._holds.get(core, 0) + 1
        try:
            if reqs is not None and any(r.kind == "knn" for r in reqs):
                return self._dispatch_mixed(
                    ladder, core, knn, points, deadline_hint, reqs
                )
            padded, n = ladder.pad(points)
            bucket = padded.shape[0]
            with _trace.span(
                "serve.dispatch", bucket=bucket, rows=n,
            ), _telemetry.timed(
                "serve_stage", stage="dispatch", bucket=bucket, rows=n,
            ):
                out = self._dispatch_resilient(core, padded, deadline_hint)
            return out[:n], n / bucket
        finally:
            self._unhold(core)

    def _unhold(self, core) -> None:
        """A batch on ``core`` is done: the last one in flight on a core
        that a hot_swap replaced, or on a closed engine's, frees its CUDA
        graphs."""
        with self._swap_lock:
            n = self._holds.pop(core) - 1
            if n:
                self._holds[core] = n
                return
            retired = core is not self.core or self._closed
        if retired:
            core.release_graphs()

    def _dispatch_mixed(self, ladder, core, knn, points, deadline_hint, reqs):
        """Split a mixed batch by request kind: ALL point-in-polygon rows
        go through one padded core dispatch, KNN rows group by k into one
        frontend dispatch each. Answers come back as a :class:`_MixedOut`
        keyed by each request's row interval; occupancy is the
        rows-weighted mean over the dispatches issued."""
        bounds, off = [], 0
        for r in reqs:
            bounds.append((r, off, off + r.n))
            off += r.n
        segs = {}
        degraded, reason, attempts = False, None, 0
        occ_rows, rows_total = 0.0, 0

        pip = [(r, a, b) for (r, a, b) in bounds if r.kind != "knn"]
        if pip:
            pts = np.concatenate([points[a:b] for (_r, a, b) in pip])
            padded, n = ladder.pad(pts)
            bucket = padded.shape[0]
            with _trace.span(
                "serve.dispatch", bucket=bucket, rows=n,
            ), _telemetry.timed(
                "serve_stage", stage="dispatch", bucket=bucket, rows=n,
            ):
                out = self._dispatch_resilient(core, padded, deadline_hint)
            if isinstance(out, DegradedResult):
                degraded, reason, attempts = True, out.reason, out.attempts
            vals = np.asarray(out[:n])
            o = 0
            for (r, a, b) in pip:
                segs[(a, b)] = vals[o : o + r.n]
                o += r.n
            occ_rows += (n / bucket) * n
            rows_total += n

        knn_reqs = [(r, a, b) for (r, a, b) in bounds if r.kind == "knn"]
        if knn_reqs:
            if knn is None:
                raise RuntimeError(
                    "KNN request admitted but the engine has no KNN frontend"
                )
            default_s = (
                None
                if deadline_hint is None
                else max(float(deadline_hint), 0.05) + self.watchdog_grace_s
            )
            by_k: dict[int, list] = {}
            for item in knn_reqs:
                by_k.setdefault(item[0].k, []).append(item)
            for k, group in sorted(by_k.items()):
                pts = np.concatenate([points[a:b] for (_r, a, b) in group])
                n = int(pts.shape[0])
                with _trace.span(
                    "serve.dispatch", rows=n, kind="knn", k=k,
                ), _telemetry.timed(
                    "serve_stage", stage="dispatch", rows=n, kind="knn", k=k,
                ):
                    out, occ = knn.dispatch(pts, k, default_s=default_s)
                if isinstance(out, DegradedResult):
                    degraded, reason, attempts = True, out.reason, out.attempts
                vals = np.asarray(out)
                o = 0
                for (r, a, b) in group:
                    segs[(a, b)] = vals[o : o + r.n]
                    o += r.n
                occ_rows += float(occ) * n
                rows_total += n

        occupancy = occ_rows / rows_total if rows_total else 1.0
        view = _MixedOut(segs, degraded=degraded, reason=reason, attempts=attempts)
        return view, occupancy

    def _on_cold_compile(self, bucket: int, signatures: int) -> None:
        """Core callback: a post-warmup dispatch introduced a new
        signature — the bounded-signature contract's tripwire."""
        _telemetry.record(
            "serve_compile", bucket=bucket, signatures=signatures,
        )

    def _dispatch_resilient(self, core, padded, deadline_hint) -> np.ndarray:
        """The core's guarded execute under the batch's deadline: the
        ``serve.dispatch`` watchdog site and transient retry (the f64 host
        oracle past the budget on the CPU only)."""
        default_s = (
            None
            if deadline_hint is None
            else max(float(deadline_hint), 0.05) + self.watchdog_grace_s
        )
        return core.execute_resilient(
            "serve.dispatch", padded, default_s=default_s
        )

    # ------------------------------------------------------- quarantine

    def _derive_park(self, raw: np.ndarray) -> np.ndarray:
        """Index-aware park point for poisoned rows: walk outward from
        the request's own finite bounding box (or the declared bounds)
        until a cell NOT in the resident index answers, the cells computed
        on the engine's device (`runtime/quarantine.find_park_point`)."""
        finite = raw[np.isfinite(raw).all(axis=1)]
        if finite.size:
            bounds = (
                float(finite[:, 0].min()), float(finite[:, 1].min()),
                float(finite[:, 0].max()), float(finite[:, 1].max()),
            )
        else:
            bounds = (0.0, 0.0, 1.0, 1.0)
        if self.admission.bounds is not None:
            bounds = self.admission.bounds
        core = self.core

        def assign(pts):
            dev = torch.from_numpy(np.asarray(pts, dtype=np.float64))
            dev = dev.to(core.device).to(core._cdt)
            cells = cells_prog(self.index_system, self.resolution, "cells")
            return cells(dev).cpu().numpy()

        return _quarantine.find_park_point(
            assign, self.index.cells.cpu().numpy(), bounds
        )


def _decode_knn_future(req, k: int) -> Future:
    """Chain the request's raw wire future ((n, 2k) f64 rows) into one
    resolving to a batched :class:`~mosaic_tpu_torch.knn.KNNAnswer`.
    Quarantined rows were answered at the park point — masked back to the
    sentinel (``ids=-1, distance=inf``) so a poisoned coordinate can never
    surface a real neighbour. Exceptions (Overloaded sheds, injected
    faults, RetryExhausted) pass through untranslated."""
    from ..knn.frontend import KNNAnswer, decode_knn

    fut: Future = Future()

    def _done(raw: Future) -> None:
        if raw.cancelled():
            fut.cancel()
            return
        exc = raw.exception()
        if exc is not None:
            fut.set_exception(exc)
            return
        try:
            out = raw.result()
            degraded = isinstance(out, DegradedResult) or bool(
                getattr(out, "degraded", False)
            )
            reason = getattr(out, "reason", None) if degraded else None
            ids, dist = decode_knn(np.asarray(out), k)
            if req.quarantine is not None:
                dist = dist.copy()
                bad = [r for (_b, r) in req.quarantine.rows]
                ids[bad] = -1
                dist[bad] = np.inf
            fut.set_result(
                KNNAnswer(ids=ids, distance=dist, degraded=degraded, reason=reason)
            )
        except BaseException as e:  # noqa: BLE001 — delivered via the future
            fut.set_exception(e)

    req.future.add_done_callback(_done)
    return fut
