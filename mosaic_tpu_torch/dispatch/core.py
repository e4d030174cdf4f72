"""The dispatch core: one bucketed, warmed, guarded execution path over
a resident index, and the registry of every bounded cache.

Port of ``mosaic_tpu/dispatch/core.py`` without its mesh and XLA parts:

- **Resilience**: :func:`guarded_call` composes the watchdog deadline,
  transient retry and degradation. Frontends name their fault site and
  hand over the attempt.
- **Cache registry**: :func:`register_cache` / :func:`bounded_cache`
  register bounded caches under one surface, :func:`cache_stats` /
  :func:`cache_view` / :func:`clear_caches` (events
  ``dispatch_cache_stats`` and ``dispatch_caches_cleared``). The port
  has no jit, so the cached values are callables: :func:`cells_prog`
  (cell assignment per system, resolution and variant) and
  :func:`stream_programs` (the `StreamJoin` function bundle per static
  spec, shared by every stream of that spec).
- :class:`DispatchCore` binds them to one resident index: full-bucket
  caps, the signature set with ``freeze()`` and ``cold_compiles``,
  :meth:`~DispatchCore.warmup` running every ladder rung, and the
  guarded execute path. `ServeEngine` delegates to it; :func:`core_for`
  keeps a bounded, occupancy-aware set of resident cores
  (``batch_cores``).

What differs from the reference, and why:

- the reference's ``cache_stats`` reports ``jit_programs``, the sizes of
  its jit caches. The port compiles nothing per shape, so that key has no
  counterpart; ``cache_stats`` reports instead ``kernels``: the kernel
  libraries bound in this process and ``backend_compiles``, the nvcc
  builds it started (`dispatch/bucket.py`);
- ``lookup=None`` resolves to ``"gather"`` on every device, as the
  port's stream does (``"mxu"`` is a TPU workaround that
  `pip_join_points` runs as the gather lane);
- ``cell_dtype=None`` computes cells in float32, the port's
  `pip_join(recheck=False)` default (the reference computes them in the
  input's dtype), so a served answer equals the port's `pip_join`;
- past the retry budget only a core on the CPU degrades to the f64 host
  oracle (`DegradedResult`); on the card the dispatch raises
  `RetryExhausted` and no work moves to the CPU (the rule of
  `pip_join`);
- on the card a dispatch replays its rung's probe as a CUDA graph
  captured at the rung's first dispatch (warmup), so its host time is a
  few calls, not the ~930 eager ops that each hand the GIL over
  (`DispatchCore._graph_run`); on the CPU it runs the eager ops;
- dispatches on one device take one lock (`_device_lock`): engines on
  one card (the router's tenants) run their dispatches one after
  another instead of interleaving their eager ops under the GIL;
- ``mesh=`` raises ``NotImplementedError`` (ROADMAP queue 1 item 12)
  and ``program_store=`` too (`dispatch/programs.py`).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading

import numpy as np
import torch

from .. import FLOAT
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..runtime import telemetry as _telemetry, watchdog as _watchdog
from ..runtime.retry import call_with_retry
from .bucket import BucketLadder, backend_compiles, dispatch_signature, mesh_key
from .programs import resolve_program_store

__all__ = [
    "DispatchCore",
    "bounded_cache",
    "cache_stats",
    "cache_view",
    "cells_prog",
    "clear_caches",
    "core_for",
    "guarded_call",
    "join_cache_view",
    "register_cache",
    "stream_programs",
]


# ------------------------------------------------------------ resilience

def guarded_call(
    site: str,
    fn,
    *args,
    default_s=None,
    policy=None,
    fallback=None,
    label=None,
    classify=None,
    retry: bool = True,
    **kwargs,
):
    """THE watchdog/retry/degradation composition, written once.

    Runs ``fn(*args, **kwargs)`` under the ``site`` watchdog deadline
    (per-site ``MOSAIC_WATCHDOG_<SITE>`` beats global ``MOSAIC_WATCHDOG_S``
    beats ``default_s``; the site doubles as the fault-injection hook),
    retried on transient failures per ``policy`` (the default
    :class:`~mosaic_tpu_torch.runtime.retry.RetryPolicy` when None); past the budget it degrades through
    ``fallback`` (:class:`DegradedResult`) or raises
    :class:`RetryExhausted`. ``retry=False`` keeps only the watchdog.
    """

    def attempt():
        return _watchdog.guard(site, fn, *args, default_s=default_s, **kwargs)

    if not retry:
        return attempt()
    kw = {"policy": policy, "fallback": fallback, "label": label or site}
    if classify is not None:
        kw["classify"] = classify
    return call_with_retry(attempt, **kw)


# ---------------------------------------------------------- cache registry

#: every bounded cache of the process, by name — the single surface
#: `cache_stats`/`clear_caches` audit. Values are `functools.lru_cache`
#: wrappers or objects speaking the same `cache_info()`/`cache_clear()`
#: protocol.
_CACHES: dict = {}


def register_cache(name: str, cached_fn):
    """Register a bounded cache under the one observability surface.
    Rejects unbounded caches."""
    info = cached_fn.cache_info()
    if info.maxsize is None:
        raise ValueError(f"dispatch cache {name!r} must be bounded")
    _CACHES[name] = cached_fn
    return cached_fn


def bounded_cache(name: str, maxsize: int):
    """Decorator: ``functools.lru_cache(maxsize)`` + registration."""
    if maxsize is None:
        raise ValueError("bounded_cache requires a finite maxsize")

    def deco(fn):
        return register_cache(name, functools.lru_cache(maxsize=maxsize)(fn))

    return deco


def _stats_of(cached_fn) -> dict:
    i = cached_fn.cache_info()
    out = {
        "hits": i.hits,
        "misses": i.misses,
        "maxsize": i.maxsize,
        "currsize": i.currsize,
    }
    extra = getattr(cached_fn, "extra_stats", None)
    if callable(extra):
        out.update(extra())
    return out


def cache_view(name: str) -> dict:
    """`{hits, misses, maxsize, currsize}` for one registered cache
    (zeros if it was never created)."""
    c = _CACHES.get(name)
    if c is None:
        return {"hits": 0, "misses": 0, "maxsize": 0, "currsize": 0}
    return _stats_of(c)


def _kernel_stats() -> dict:
    from ..kernels import _build

    return {
        "libraries": _build.loaded_libraries(),
        "backend_compiles": backend_compiles(),
    }


def cache_stats(emit: bool = True) -> dict:
    """One stats dict over every registered cache (per cache ``{hits,
    misses, maxsize, currsize}``, plus ``evictions``/``occupancy`` for
    ``batch_cores``) and ``kernels`` (libraries bound, nvcc builds). Emits
    one ``dispatch_cache_stats`` event (``emit=False`` reads silently)."""
    stats = {name: _stats_of(c) for name, c in sorted(_CACHES.items())}
    stats["kernels"] = _kernel_stats()
    if emit:
        _telemetry.record("dispatch_cache_stats", **stats)
    return stats


def clear_caches(names=None, emit: bool = True) -> dict:
    """Release registered caches (all of them, or just ``names``);
    returns the pre-clear :func:`cache_stats`. A cache key holds its index
    system strongly, so a server cycling many custom grids calls this to
    let them go; caches regrow on next use. Emits
    ``dispatch_caches_cleared``."""
    stats = cache_stats(emit=False)
    targets = (
        list(_CACHES.values())
        if names is None
        else [_CACHES[n] for n in names if n in _CACHES]
    )
    for c in targets:
        c.cache_clear()
    if emit:
        _telemetry.record("dispatch_caches_cleared", **stats)
    return stats


# ------------------------------------------------------------- programs

@functools.lru_cache(maxsize=1)
def _join_mod():
    # deferred: sql.join imports this package at module level
    from ..sql import join

    return join


@bounded_cache("cells_prog", 64)
def cells_prog(index_system, resolution: int, variant: str = "cells"):
    """The cell-assignment callable per (system, res, variant): ``cells``
    (`point_to_cell`), ``margin`` (`point_to_cell_margin`) or ``alt``
    (`point_to_cell_alt`). The key holds the index system (built-ins
    are cheap); :func:`clear_caches` is the escape hatch."""
    if variant == "margin":
        return lambda p: index_system.point_to_cell_margin(p, resolution)
    if variant == "alt":
        return lambda p: index_system.point_to_cell_alt(p, resolution)
    return lambda p: index_system.point_to_cell(p, resolution)


def join_cache_view() -> dict:
    """The `sql.join.join_cache_stats` dict, served from the registry:
    ``{"cells_prog": {...}, "kernels": {...}}``."""
    return {"cells_prog": cache_view("cells_prog"), "kernels": _kernel_stats()}


@bounded_cache("stream_programs", 16)
def stream_programs(
    index_system,
    resolution: int,
    *,
    dtype,
    cell_dtype,
    found_cap,
    heavy_cap,
    lookup,
    compaction,
    probe,
    convex_cap,
    prefetch,
):
    """The `StreamJoin` function bundle per static spec: two StreamJoins
    over the same (system, resolution, caps, lanes) share one bundle."""
    from ..sql import stream as m

    return m.build_stream_programs(
        index_system, resolution, dtype=dtype, cell_dtype=cell_dtype,
        found_cap=found_cap, heavy_cap=heavy_cap, lookup=lookup,
        compaction=compaction, probe=probe, convex_cap=convex_cap,
        prefetch=prefetch,
    )


#: one dispatch at a time per device (`_device_lock`)
_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_lock(dev: torch.device) -> threading.Lock:
    """The lock that serializes :meth:`DispatchCore.execute_padded` on
    ``dev``. A dispatch is several hundred eager ops and each releases and
    retakes the GIL, so engines interleaving their dispatches op by op
    (one batcher thread per engine, several tenants on one card) hand the
    GIL to each other at every op, while the card runs their work one
    stream at a time anyway: taken whole, each dispatch runs at its own
    speed."""
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(str(dev), threading.Lock())


def _device_scope(dev: torch.device):
    """Make ``dev`` current for the block on a CUDA device: a batcher or
    watchdog thread never relies on the current device of a thread the
    caller did not create."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


# ---------------------------------------------------------- DispatchCore

class DispatchCore:
    """One bucketed, warmed, guarded execution path over a resident
    ChipIndex — the unit `ServeEngine` delegates to.

    Owns the pad-to-bucket ladder, full-bucket caps, the signature set
    with cold-compile accounting, :meth:`warmup` running every rung, and
    the guarded execute path (watchdog + retry, and on the CPU the f64
    host-oracle degradation). Runs on the index's device.
    """

    def __init__(
        self,
        index,
        index_system,
        resolution: int,
        *,
        ladder: BucketLadder | None = None,
        writeback: str = "scatter",
        lookup: str | None = None,
        probe: str = "scatter",
        cell_dtype=None,
        mesh=None,
        on_cold_compile=None,
        program_store=None,
    ):
        mesh_key(mesh)
        resolve_program_store(program_store)
        m = _join_mod()
        self.index = index
        self.index_system = index_system
        self.resolution = index_system.resolution_arg(resolution)
        self.ladder = ladder or BucketLadder()
        self.writeback = writeback
        # force-lane env resolution happens once, here: dispatch uses the
        # pinned value so the signature stays honest
        self.probe = m.resolve_probe_mode(probe)
        if self.probe != "scatter" and writeback == "direct":
            raise ValueError(
                "probe='adaptive' requires writeback scatter|gather"
            )
        self.cell_dtype = cell_dtype
        self._cdt = FLOAT if cell_dtype is None else m._as_torch_dtype(cell_dtype)
        self.mesh = None
        self.lookup = lookup or "gather"
        self.device = index.device
        self._dtype = index.border.verts.dtype
        self._np_dtype = np.dtype(str(self._dtype).removeprefix("torch."))
        self._host = getattr(index, "host", None)
        self._shift = (
            self._host.shift
            if self._host is not None
            else index.border.shift.cpu().numpy()
        )
        self._signatures: set = set()
        self._warmed: frozenset | None = None
        self._cold_compiles = 0
        self._on_cold_compile = on_cold_compile
        #: bucket -> the rung's captured probe (CUDA only, `_graph_run`)
        self._graphs: dict = {}

    # ------------------------------------------------------- accounting

    @property
    def signatures(self) -> set:
        return self._signatures

    @property
    def cold_compiles(self) -> int:
        return self._cold_compiles

    @property
    def warmed(self) -> bool:
        return self._warmed is not None

    def caps(self, bucket: int):
        """Full-bucket caps, so tier overflow is structurally impossible
        and the static-argument set per bucket never changes."""
        fcap = None if self.writeback == "direct" else bucket
        hcap = bucket if self.index.num_heavy_cells else None
        ccap = (
            bucket
            if self.probe != "scatter" and self.index.num_convex_cells
            else None
        )
        return fcap, hcap, ccap

    def signature(self, bucket: int) -> tuple:
        fcap, hcap, ccap = self.caps(bucket)
        return dispatch_signature(
            bucket, self.index, writeback=self.writeback,
            lookup=self.lookup, found_cap=fcap, heavy_cap=hcap,
            probe=self.probe, convex_cap=ccap,
        )

    def freeze(self) -> None:
        """Snapshot the signature set: any later dispatch introducing a
        new signature counts as a cold compile (the tripwire)."""
        self._warmed = frozenset(self._signatures)

    def _uses_kernel(self) -> bool:
        """Does the probe launch ``pip_heavy_tiled`` on this index?"""
        return (
            self.device.type == "cuda"
            and self.probe in ("adaptive", "adaptive-heavy")
            and self.index.num_heavy_cells > 0
        )

    # ---------------------------------------------------------- execute

    def stage(self, padded: np.ndarray):
        """Host → device: the bucket's points in the cell dtype, and the
        recentred points in the index's dtype (cast on the host, as
        `pip_join` casts them)."""
        bucket = padded.shape[0]
        with _trace.span(
            "dispatch.transfer.h2d", nbytes=int(padded.nbytes), bucket=bucket,
        ):
            pts = torch.from_numpy(np.ascontiguousarray(padded))
            pts = pts.to(self.device).to(self._cdt)
        with _trace.span(
            "dispatch.transfer.h2d", nbytes=int(padded.nbytes),
            bucket=bucket, shifted=True,
        ):
            shifted = torch.from_numpy(
                np.asarray(padded - self._shift, dtype=self._np_dtype)
            ).to(self.device)
        return pts, shifted

    def probe_staged(self, pts: torch.Tensor, shifted: torch.Tensor):
        """Cells and the probe of one staged bucket, on the device: the
        (B,) int32 rows, not read back."""
        fcap, hcap, ccap = self.caps(pts.shape[0])
        cells = cells_prog(self.index_system, self.resolution, "cells")(pts)
        return _join_mod().pip_join_points(
            shifted, cells, self.index,
            heavy_cap=hcap, found_cap=fcap, writeback=self.writeback,
            lookup=self.lookup, probe=self.probe, convex_cap=ccap,
        )

    def execute_padded(self, padded: np.ndarray) -> np.ndarray:
        """One exact device join of a full-bucket batch (the unit warmup
        runs and dispatch replays); the (B,) int32 rows on the host."""
        bucket = padded.shape[0]
        sig = self.signature(bucket)
        new_sig = sig not in self._signatures
        if new_sig:
            self._signatures.add(sig)
            if self._warmed is not None:
                self._cold_compiles += 1
                if self._on_cold_compile is not None:
                    self._on_cold_compile(bucket, len(self._signatures))
                else:
                    _telemetry.record(
                        "dispatch_compile", bucket=bucket,
                        signatures=len(self._signatures),
                    )
        # a new signature's dispatch is spanned whole, stamped with the
        # nvcc builds it started; warm replays skip the span
        comp_span = comp_c0 = None
        if new_sig:
            comp_c0 = backend_compiles()
            comp_span = _trace.start_span(
                "dispatch.compile", bucket=bucket,
                signatures=len(self._signatures),
            )
        try:
            with _device_lock(self.device), _device_scope(self.device):
                if self.device.type == "cuda":
                    out = self._graph_run(padded)
                else:
                    out = self.probe_staged(*self.stage(padded))
                with _trace.span(
                    "dispatch.transfer.d2h", nbytes=int(out.numel()) * 4,
                    bucket=bucket,
                ):
                    return out.cpu().numpy()
        finally:
            if comp_span is not None:
                comp_span.set(backend_compiles=backend_compiles() - comp_c0)
                comp_span.end()

    def _graph_run(self, padded: np.ndarray) -> torch.Tensor:
        """One bucket's probe on the card as a CUDA graph replay: the
        rung's first dispatch runs the probe's eager ops and captures them
        into a graph on its staged tensors; later dispatches copy their
        staged points into those tensors and replay it. A dispatch is then
        a handful of host calls instead of several hundred eager ops, each
        of which hands the GIL over (the serving path's bound, PERF.md
        §5). The probe makes no host sync at full-bucket caps, so its
        graph is its eager run, bit for bit. The kernel wrappers record
        the launches they capture, and each replay counts them
        (`kernels._build.captured_launches`)."""
        from ..kernels import _build

        bucket = padded.shape[0]
        g = self._graphs.get(bucket)
        if g is not None:
            pts, shifted = self.stage(padded)
            g["pts"].copy_(pts)
            g["shifted"].copy_(shifted)
            g["graph"].replay()
            _build.count_replay(g["launches"])
            return g["out"]
        pts, shifted = self.stage(padded)
        # the eager run answers this dispatch and makes every lazy
        # initialisation (device constant tables, the kernel library, the
        # allocator's blocks) before the capture
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            out = self.probe_staged(pts, shifted)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection during the capture: a collected core's
        # graphs free their memory pools (cudaFree), which would
        # invalidate it (`torch.cuda.graph` collects once before it)
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with _build.captured_launches() as launches, torch.cuda.graph(
                graph, capture_error_mode="thread_local"
            ):
                gout = self.probe_staged(pts, shifted)
        finally:
            if gc_was_enabled:
                gc.enable()
        self._graphs[bucket] = {
            "graph": graph, "pts": pts, "shifted": shifted, "out": gout,
            "launches": launches,
        }
        return out

    def release_graphs(self) -> None:
        """Free the rungs' CUDA graphs now. A closed engine can live on in
        a reference cycle until a full garbage collection, and a graph
        freed there is freed in the middle of whatever dispatch the
        process is running. A later dispatch captures its rung again."""
        with _device_lock(self.device):
            self._graphs = {}

    def execute(self, points) -> np.ndarray:
        """Pad → dispatch → unpad (exact, unguarded)."""
        padded, n = self.ladder.pad(points)
        return self.execute_padded(padded)[:n]

    def execute_resilient(
        self, site: str, padded: np.ndarray, *, default_s=None, policy=None,
    ) -> np.ndarray:
        """:meth:`execute_padded` under the ``site`` watchdog deadline and
        transient retry. Past the budget a core on the CPU degrades to the
        exact f64 host oracle (`DegradedResult`); on the card
        `RetryExhausted` propagates."""
        fallback = None
        if self._host is not None and self.device.type == "cpu":
            m = _join_mod()
            fallback = lambda: m.host_join(  # noqa: E731
                padded, self._host, self.index_system, self.resolution
            )
        return guarded_call(
            site, self.execute_padded, padded,
            default_s=default_s, policy=policy, fallback=fallback,
        )

    # ----------------------------------------------------------- warmup

    def load_kernels(self) -> list[str]:
        """Build (once per machine) and bind the kernel library the probe
        launches, so no request pays for it; [] when none is launched."""
        if not self._uses_kernel():
            return []
        from ..kernels import _build

        _build.load("pip")
        return ["pip"]

    def warmup(self) -> dict:
        """Bind the kernel library, run every ladder rung once against the
        resident index (first launches, the caching allocator), then
        freeze the signature set. Returns ``{"buckets", "seconds",
        "signatures", "backend_compiles"}`` (nvcc builds started)."""
        t0 = backend_compiles()
        with _telemetry.capture() as events, _trace.span(
            "dispatch.warmup", buckets=len(self.ladder.buckets), devices=1,
        ):
            self.load_kernels()
            for b in self.ladder.buckets:
                pts = np.zeros((b, 2), dtype=np.float64)
                with _telemetry.timed(
                    "dispatch_stage", stage="warmup", bucket=b
                ):
                    self.execute_padded(pts)
        total = sum(
            e["seconds"]
            for e in events
            if e.get("stage") == "warmup" and "seconds" in e
        )
        self.freeze()
        out = {
            "buckets": len(self.ladder.buckets),
            "seconds": round(total, 4),
            "signatures": len(self._signatures),
            "backend_compiles": backend_compiles() - t0,
        }
        _telemetry.record("dispatch_warmup", **out)
        return out


# -------------------------------------------- resident-core memoization

class _CoreCache:
    """A bounded occupancy-aware LRU cache of resident
    :class:`DispatchCore` instances, speaking the `lru_cache`
    `cache_info()`/`cache_clear()` protocol so it registers in
    :func:`cache_stats` like every other cache.

    Eviction picks the least-recently-used entry, with COLD cores (never
    warmed) evicted before warmed ones regardless of recency. Evictions
    and occupancy land in ``extra_stats`` and on the metrics registry
    (``dispatch.core_cache_evictions`` counter,
    ``dispatch.core_cache_occupancy`` gauge)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: dict = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key):
        core = self._d.get(key)
        if core is not None:
            self._hits += 1
            # LRU recency: a hit moves the entry to the back
            self._d[key] = self._d.pop(key)
        return core

    def _evict_one(self) -> None:
        victim = next(
            (k for k, c in self._d.items() if not getattr(c, "warmed", False)),
            next(iter(self._d)),
        )
        self._d.pop(victim)
        self._evictions += 1
        _metrics.counter(
            "dispatch.core_cache_evictions",
            "resident DispatchCores dropped by the occupancy-aware LRU",
        ).inc()

    def put(self, key, core):
        self._misses += 1
        while len(self._d) >= self.maxsize:
            self._evict_one()
        self._d[key] = core
        _metrics.gauge(
            "dispatch.core_cache_occupancy",
            "resident DispatchCore slots in use / maxsize",
        ).set(self.occupancy())

    def occupancy(self) -> float:
        return len(self._d) / max(self.maxsize, 1)

    def extra_stats(self) -> dict:
        return {
            "evictions": self._evictions,
            "occupancy": round(self.occupancy(), 4),
        }

    def cache_info(self):
        return functools._CacheInfo(
            self._hits, self._misses, self.maxsize, len(self._d)
        )

    def cache_clear(self):
        self._d.clear()
        self._hits = 0
        self._misses = 0
        self._evictions = 0


_BATCH_CORES = register_cache("batch_cores", _CoreCache(maxsize=8))


def core_for(
    index,
    index_system,
    resolution: int,
    *,
    ladder: BucketLadder | None = None,
    writeback: str = "scatter",
    lookup: str | None = None,
    probe: str = "scatter",
    cell_dtype=None,
    mesh=None,
) -> DispatchCore:
    """The process-cached :class:`DispatchCore` for an (index, static
    arguments) combination. The cache holds the index strongly, so the
    ``id(index)`` part of the key cannot be recycled while the entry
    lives."""
    key = (
        id(index), id(index_system), index_system.resolution_arg(resolution),
        writeback, lookup, probe, str(cell_dtype), mesh_key(mesh),
        ladder or BucketLadder(),
    )
    core = _BATCH_CORES.get(key)
    if core is None or core.index is not index:
        core = DispatchCore(
            index, index_system, resolution, ladder=ladder,
            writeback=writeback, lookup=lookup, probe=probe,
            cell_dtype=cell_dtype,
        )
        _BATCH_CORES.put(key, core)
    return core
