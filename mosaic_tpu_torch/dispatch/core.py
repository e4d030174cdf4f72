"""The dispatch core: one bucketed, warmed, guarded execution path over
a resident index, its data-parallel placement, and the registry of every
bounded cache.

Port of ``mosaic_tpu/dispatch/core.py`` without its XLA parts:

- **Resilience**: :func:`guarded_call` composes the watchdog deadline,
  transient retry and degradation. Frontends name their fault site and
  hand over the attempt.
- **Cache registry**: :func:`register_cache` / :func:`bounded_cache`
  register bounded caches under one surface, :func:`cache_stats` /
  :func:`cache_view` / :func:`clear_caches` (events
  ``dispatch_cache_stats`` and ``dispatch_caches_cleared``). The port
  has no jit, so the cached values are callables: :func:`cells_prog`
  (cell assignment per system, resolution and variant),
  :func:`stream_programs` (the `StreamJoin` function bundle per static
  spec, shared by every stream of that spec) and
  :func:`sharded_join_prog` (the data-parallel probe per mesh and caps).
- **Placement**: :func:`data_mesh`, :func:`resolve_mesh` (``mesh=`` and
  the ``MOSAIC_MESH`` knob) and :func:`sharded_pointwise`, the
  data-parallel lane: points sharded over a `parallel.mesh.Mesh`, the
  index replicated, so every per-point result is the single-device one.
- :class:`DispatchCore` binds them to one resident index: full-bucket
  caps (per shard under a mesh), the signature set with ``freeze()`` and
  ``cold_compiles``, :meth:`~DispatchCore.warmup` running every ladder
  rung, and the guarded execute path. `ServeEngine` delegates to it;
  :func:`core_for` keeps a bounded, occupancy-aware set of resident
  cores (``batch_cores``).

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
  (`DispatchCore._graph_run`); under a mesh each shard has its own graph
  per rung, captured on its shard's device. On the CPU it runs the eager
  ops;
- dispatches take the lock of each distinct device they run on, once, in
  one order (`_device_locks`): engines on one card (the router's
  tenants) run their dispatches one after another instead of
  interleaving their eager ops under the GIL, a logical mesh that lists
  one device several times takes its lock once, and two meshes listing
  the same devices in another order cannot deadlock on each other;
- a mesh is the port's single-controller `parallel.mesh.Mesh` of torch
  devices; its device list may repeat a device (a logical mesh), while
  :func:`data_mesh` over the platform's devices refuses more than there
  are, as the reference's does;
- ``program_store=`` (or ``MOSAIC_PROGRAM_STORE``) binds the program
  store (`dispatch/programs.py`): per rung the reference's ``cells`` and
  ``join`` entries, JSON manifests of the rung's statics and of the kernel
  library the probe launches, and that library's bytes as an entry of its
  own, so a relaunch binds it without nvcc. A refused entry takes the nvcc
  path and is exported again; nothing falls back to a plain torch
  version. A meshed core refuses the store (``program_store_refused``),
  as the reference's does. The rungs' CUDA graphs are captured at warmup
  either way: a graph cannot be stored.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os
import threading
import time

import numpy as np
import torch

from .. import FLOAT
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..parallel import mesh as _mesh
from ..runtime import checkpoint as _checkpoint
from ..runtime import telemetry as _telemetry, watchdog as _watchdog
from ..runtime.retry import call_with_retry
from . import programs as _programs
from .bucket import BucketLadder, backend_compiles, dispatch_signature, mesh_key
from .programs import core_program_statics, program_key, resolve_program_store

__all__ = [
    "DispatchCore",
    "bounded_cache",
    "cache_stats",
    "cache_view",
    "cells_prog",
    "clear_caches",
    "core_for",
    "data_mesh",
    "guarded_call",
    "join_cache_view",
    "register_cache",
    "resolve_mesh",
    "sharded_join_prog",
    "sharded_pointwise",
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
    retried on transient failures per ``policy`` (env-tuned
    ``MOSAIC_RETRY_*``, :meth:`~mosaic_tpu_torch.runtime.retry.RetryPolicy.from_env`,
    when None); past the budget it degrades through
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
    mesh=None,
):
    """The `StreamJoin` function bundle per static spec: two StreamJoins
    over the same (system, resolution, caps, lanes, placement) share one
    bundle."""
    from ..sql import stream as m

    return m.build_stream_programs(
        index_system, resolution, dtype=dtype, cell_dtype=cell_dtype,
        found_cap=found_cap, heavy_cap=heavy_cap, lookup=lookup,
        compaction=compaction, probe=probe, convex_cap=convex_cap,
        prefetch=prefetch, mesh=mesh,
    )


#: one dispatch at a time per device (`_device_locks`)
_DEVICE_LOCKS: dict = {}
_DEVICE_LOCKS_GUARD = threading.Lock()


def _device_lock(dev) -> threading.Lock:
    """The lock that serializes dispatches on ``dev`` (a device or its
    string). A dispatch is several hundred eager ops and each releases
    and retakes the GIL, so engines interleaving their dispatches op by
    op (one batcher thread per engine, several tenants on one card) hand
    the GIL to each other at every op, while the card runs their work one
    stream at a time anyway: taken whole, each dispatch runs at its own
    speed."""
    with _DEVICE_LOCKS_GUARD:
        return _DEVICE_LOCKS.setdefault(str(dev), threading.Lock())


@contextlib.contextmanager
def _device_locks(devices):
    """Hold the lock of every distinct device in ``devices`` for the
    block: each taken once (a logical mesh lists one device several
    times; a plain lock taken twice by one thread would deadlock), in one
    fixed order, by device string (two meshes listing the same devices in
    another order take them in the same order, so they cannot deadlock
    on each other)."""
    locks = [_device_lock(d) for d in sorted({str(d) for d in devices})]
    taken = []
    try:
        for lock in locks:
            lock.acquire()
            taken.append(lock)
        yield
    finally:
        for lock in reversed(taken):
            lock.release()


#: make a device current for a block on a CUDA device: a batcher or
#: watchdog thread never relies on the current device of a thread the
#: caller did not create
_device_scope = _mesh.device_scope


# -------------------------------------------------------------- placement

def data_mesh(n_devices: int | None = None, devices=None, device=None):
    """A 1-D ``("dp",)`` data-parallel mesh over the first ``n_devices``
    of ``devices`` (default: the platform's real devices of ``device``'s
    kind, the card unless ``device="cpu"``; all of them when
    ``n_devices`` is None) — the placement of the sharded dispatch lane:
    points sharded over ``dp``, the index replicated. Asking for more
    devices than the list holds raises ``ValueError``; a logical mesh
    repeats a device in ``devices`` (``[dev] * n``)."""
    if devices is None:
        from .. import resolve_device

        devs = _mesh.platform_devices(resolve_device(device).type)
    else:
        devs = list(devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1 or n > len(devs):
        raise ValueError(
            f"mesh wants {n} devices but the platform exposes {len(devs)}"
        )
    return _mesh.Mesh(devs[:n], ("dp",))


def resolve_mesh(mesh, device=None):
    """Normalize a frontend ``mesh=`` argument once, on the host:

    - ``None`` → the ``MOSAIC_MESH`` knob (``"4"`` or ``"dp4"`` → a
      4-device data mesh; unset, empty or at most 1 → single-device
      dispatch; anything else raises ``ValueError``);
    - an int → :func:`data_mesh` over that many devices (None at 1 or
      less);
    - a `parallel.mesh.Mesh` → used as it is.

    ``device`` is the frontend's device: an int or the knob takes real
    devices of its kind, and a mesh of another kind is refused (no shard
    of a dispatch on the card runs on the CPU)."""
    if mesh is None:
        raw = os.environ.get("MOSAIC_MESH", "").strip().lower()
        if not raw:
            return None
        if raw.startswith("dp"):
            raw = raw[2:]
        try:
            n = int(raw)
        except ValueError:
            raise ValueError(
                f"MOSAIC_MESH={raw!r}: expected a device count like '4' "
                "or 'dp4'"
            ) from None
        if n <= 1:
            return None
        return data_mesh(n, device=device)
    if isinstance(mesh, int):
        return data_mesh(mesh, device=device) if mesh > 1 else None
    if not isinstance(mesh, _mesh.Mesh):
        raise TypeError(
            f"mesh= takes a device count or a parallel.mesh.Mesh, got "
            f"{type(mesh).__name__}"
        )
    if device is not None and mesh.type != torch.device(device).type:
        raise ValueError(
            f"a mesh of {mesh.type} devices cannot serve a frontend on "
            f"{torch.device(device)}"
        )
    return mesh


def sharded_pointwise(fn, mesh):
    """``fn(points, cells, index) -> out`` (a tensor or a tuple) run data
    parallel: points and cells sharded over every axis of ``mesh``, the
    index replicated (placed once per distinct device; pass a
    `parallel.mesh.Placed` to reuse a placement), each output's axis 0
    concatenated back in shard order. Every per-point result depends only
    on that point and the replicated index, so the sharded call equals
    the single-device call bit for bit."""

    def run(points, cells, index):
        return _mesh.run_sharded(
            fn, mesh, sharded=(points, cells), replicated=(index,)
        )

    return run


@bounded_cache("sharded_join", 32)
def sharded_join_prog(
    mesh,
    *,
    writeback: str,
    lookup: str,
    probe: str,
    found_cap,
    heavy_cap,
    convex_cap,
):
    """The sharded exact probe per (mesh, static arguments): ``(shifted,
    cells, index) -> rows``, the single-device probe's multi-device twin.
    Caps are PER SHARD (full per-shard rows under the ladder), so overflow
    stays structurally impossible at any device count; under
    ``probe="adaptive"`` on the card each shard launches
    ``pip_heavy_tiled`` once."""
    m = _join_mod()

    def step(shifted, cells, index):
        return m.pip_join_points(
            shifted, cells, index,
            heavy_cap=heavy_cap, found_cap=found_cap,
            writeback=writeback, lookup=lookup,
            probe=probe, convex_cap=convex_cap,
        )

    return sharded_pointwise(step, mesh)


# ---------------------------------------------------------- DispatchCore

class DispatchCore:
    """One bucketed, warmed, guarded execution path over a resident
    ChipIndex — the unit `ServeEngine` delegates to.

    Owns the pad-to-bucket ladder, full-bucket caps, the signature set
    with cold-compile accounting, :meth:`warmup` running every rung, and
    the guarded execute path (watchdog + retry, and on the CPU the f64
    host-oracle degradation). Runs on the index's device; with ``mesh``
    (a device count, a `parallel.mesh.Mesh`, or None for the
    ``MOSAIC_MESH`` knob) each dispatch runs data parallel over the mesh
    with the index replicated, bit for bit the single-device answer.
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
        self.lookup = lookup or "gather"
        self.device = index.device
        self.mesh = resolve_mesh(mesh, device=self.device)
        #: the index once per distinct device of the mesh; the devices a
        #: dispatch locks; where it stages its points
        self._placed = None
        self._lock_devices = [self.device]
        self._stage_device = self.device
        if self.mesh is not None:
            if self.ladder.min_bucket % self.mesh.size:
                raise ValueError(
                    f"min_bucket {self.ladder.min_bucket} must divide evenly "
                    f"over the {self.mesh.size}-device mesh"
                )
            self._placed = _mesh.replicas(index, self.mesh)
            self._lock_devices = self.mesh.distinct
            self._stage_device = self.mesh.first
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
        #: the rungs' captured probes (CUDA only, `_graph_run`): keyed by
        #: bucket, or by (bucket, shard) under a mesh
        self._graphs: dict = {}
        #: seconds this core spent capturing graphs (a store-warmed core
        #: still captures every rung)
        self.capture_seconds = 0.0
        # the program store (dispatch/programs.py): explicit arg beats
        # the MOSAIC_PROGRAM_STORE knob. A meshed core refuses it, as the
        # reference's does (recorded, never silent).
        self._programs = resolve_program_store(program_store)
        if self._programs is not None and self.mesh is not None:
            _telemetry.record(
                "program_store_refused", reason="mesh",
                devices=self.mesh.size,
            )
            self._programs = None
        self._aot: dict = {}  # bucket -> (cells manifest, join manifest) | None
        self._aot_libraries: set = set()  # libraries bound through the store
        self.aot_stats = {"loaded": 0, "exported": 0, "fallback": 0}

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
        """Full-bucket caps — PER SHARD under a mesh — so tier overflow
        is structurally impossible and the static-argument set per bucket
        never changes."""
        return self._caps_rows(
            bucket if self.mesh is None else bucket // self.mesh.size
        )

    def _caps_rows(self, rows: int):
        fcap = None if self.writeback == "direct" else rows
        hcap = rows if self.index.num_heavy_cells else None
        ccap = (
            rows
            if self.probe != "scatter" and self.index.num_convex_cells
            else None
        )
        return fcap, hcap, ccap

    def signature(self, bucket: int) -> tuple:
        fcap, hcap, ccap = self.caps(bucket)
        return dispatch_signature(
            bucket, self.index, writeback=self.writeback,
            lookup=self.lookup, found_cap=fcap, heavy_cap=hcap,
            probe=self.probe, convex_cap=ccap, mesh=self.mesh,
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

    def kernel_libraries(self) -> list[str]:
        """The kernel libraries the probe launches: ``["pip"]`` when it
        reaches ``pip_heavy_tiled``, else none."""
        return ["pip"] if self._uses_kernel() else []

    # ------------------------------------------------------ AOT programs

    def _index_fingerprint(self) -> str:
        """Restart-stable identity of the index for program-store keys
        (`runtime.checkpoint.index_identity`: the cells fingerprint, with
        an epochal index's epoch token folded in, so two epochs never
        share a key)."""
        if getattr(self, "_index_fp", None) is None:
            self._index_fp = _checkpoint.index_identity(self.index)
        return self._index_fp

    def _epoch_meta(self) -> dict:
        """Epoch provenance for program-store sidecars (empty for
        build-once indexes): what `ProgramStore.gc_superseded` keys on."""
        series = getattr(self.index, "epoch_series", None)
        if not series:
            return {}
        return {
            "index_series": series,
            "index_epoch": int(getattr(self.index, "epoch", 0)),
        }

    def _aot_bundle(self, bucket: int):
        """The bucket's ``(cells, join)`` manifests: loaded from the
        program store when valid entries exist, otherwise exported, the
        libraries they name bound first. Any other failure records
        ``program_store_fallback`` and leaves the bucket on the nvcc path
        (`kernels._build.load` at the first launch)."""
        if bucket in self._aot:
            return self._aot[bucket]
        with _trace.span("dispatch.aot", bucket=bucket):
            try:
                bundle = self._load_or_export(bucket)
            except Exception as e:  # lint: broad-except-ok (the store is an optimization: ANY failure in it must leave the dispatch on the nvcc path, not take it down)
                _telemetry.record(
                    "program_store_fallback", bucket=bucket,
                    error=repr(e)[:200],
                )
                self.aot_stats["fallback"] += 1
                bundle = None
        self._aot[bucket] = bundle
        return bundle

    def _load_or_export(self, bucket: int):
        fp = self._index_fingerprint()
        out = []
        cell_libs = self.index_system.cell_kernel_libraries(self.device)
        for kind, libs in (("cells", cell_libs), ("join", self.kernel_libraries())):
            statics = core_program_statics(self, bucket, kind)
            out.append(_programs.one_program(
                self._programs, program_key(fp, kind, **statics),
                _programs.manifest(kind, statics, libs),
                {"kind": kind, "bucket": bucket, **self._epoch_meta()},
                self.aot_stats, self._bind_library,
            ))
        return tuple(out)

    def _bind_library(self, name: str) -> None:
        """Kernel library ``name`` through the store, once per core: bound
        from its entry, or built by nvcc and exported."""
        if name not in self._aot_libraries:
            self._aot_libraries.add(name)
            _programs.bind_library(self._programs, name, self.aot_stats)

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
            pts = pts.to(self._stage_device).to(self._cdt)
        with _trace.span(
            "dispatch.transfer.h2d", nbytes=int(padded.nbytes),
            bucket=bucket, shifted=True,
        ):
            shifted = torch.from_numpy(
                np.asarray(padded - self._shift, dtype=self._np_dtype)
            ).to(self._stage_device)
        return pts, shifted

    def probe_staged(self, pts: torch.Tensor, shifted: torch.Tensor):
        """Cells and the probe of one staged bucket, on the device: the
        (B,) int32 rows, not read back. Under a mesh the probe runs once
        a shard (`sharded_join_prog`), its rows concatenated on the
        mesh's first device."""
        if self.mesh is None:
            return self._shard_probe(pts, shifted, self.index)
        fcap, hcap, ccap = self.caps(pts.shape[0])
        cells = cells_prog(self.index_system, self.resolution, "cells")(pts)
        prog = sharded_join_prog(
            self.mesh, writeback=self.writeback, lookup=self.lookup,
            probe=self.probe, found_cap=fcap, heavy_cap=hcap, convex_cap=ccap,
        )
        return prog(shifted, cells, self._placed)

    def _shard_probe(self, pts, shifted, index):
        """Cells and the probe of one shard's rows (all of a bucket's
        without a mesh) against ``index``, at caps of the shard's rows."""
        fcap, hcap, ccap = self._caps_rows(pts.shape[0])
        cells = cells_prog(self.index_system, self.resolution, "cells")(pts)
        return _join_mod().pip_join_points(
            shifted, cells, index,
            heavy_cap=hcap, found_cap=fcap, writeback=self.writeback,
            lookup=self.lookup, probe=self.probe, convex_cap=ccap,
        )

    def execute_padded(self, padded: np.ndarray) -> np.ndarray:
        """One exact device join of a full-bucket batch (the unit warmup
        runs and dispatch replays); the (B,) int32 rows on the host."""
        bucket = padded.shape[0]
        if self.mesh is not None and bucket % self.mesh.size:
            raise ValueError(
                f"bucket {bucket} does not divide over the "
                f"{self.mesh.size}-device mesh"
            )
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
            if self._programs is not None:
                # binds the rung's kernel library from the store before
                # the probe's first launch could start nvcc
                self._aot_bundle(bucket)
            with _device_locks(self._lock_devices), _device_scope(
                self._stage_device
            ):
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
        """One bucket's probe on the card as CUDA graph replays: the
        rung's first dispatch runs the probe's eager ops and captures them
        into a graph on its staged tensors; later dispatches copy their
        staged points into those tensors and replay it. A dispatch is then
        a handful of host calls instead of several hundred eager ops, each
        of which hands the GIL over (the serving path's bound, PERF.md
        §5). The probe makes no host sync at full-bucket caps, so its
        graph is its eager run, bit for bit. Under a mesh each shard has
        its own graph per rung, captured on its shard's device, and the
        shards' rows are concatenated on the mesh's first device. The
        kernel wrappers record the launches they capture, and each replay
        counts them (`kernels._build.captured_launches`)."""
        bucket = padded.shape[0]
        pts, shifted = self.stage(padded)
        if self.mesh is None:
            return self._graph_shard(bucket, self.device, pts, shifted, self.index)
        pp = _mesh.shard(pts, self.mesh)
        ss = _mesh.shard(shifted, self.mesh)
        outs = [
            self._graph_shard(
                (bucket, i), dev, pp[i], ss[i], self._placed[str(dev)]
            )
            for i, dev in enumerate(self.mesh.device_list)
        ]
        return torch.cat([o.to(self._stage_device) for o in outs])

    def _graph_shard(self, key, dev, pts, shifted, index) -> torch.Tensor:
        """The probe of one shard's staged rows on ``dev``: a replay of
        the graph under ``key``, or the eager run that answers the first
        dispatch followed by the capture."""
        from ..kernels import _build

        with _device_scope(dev):
            g = self._graphs.get(key)
            if g is not None:
                g["pts"].copy_(pts)
                g["shifted"].copy_(shifted)
                g["graph"].replay()
                _build.count_replay(g["launches"])
                return g["out"]
            # the graph's own static inputs (a shard is a view of the
            # staged bucket)
            pts, shifted = pts.clone(), shifted.clone()
            # the eager run answers this dispatch and makes every lazy
            # initialisation (device constant tables, the kernel library,
            # the allocator's blocks) before the capture
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                out = self._shard_probe(pts, shifted, index)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # no garbage collection during the capture: a collected core's
            # graphs free their memory pools (cudaFree), which would
            # invalidate it (`torch.cuda.graph` collects once before it)
            gc_was_enabled = gc.isenabled()
            gc.disable()
            t0 = time.perf_counter()
            try:
                with _build.captured_launches() as launches, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"
                ):
                    gout = self._shard_probe(pts, shifted, index)
            finally:
                self.capture_seconds += time.perf_counter() - t0
                if gc_was_enabled:
                    gc.enable()
            self._graphs[key] = {
                "graph": graph, "pts": pts, "shifted": shifted, "out": gout,
                "launches": launches,
            }
            return out

    def release_graphs(self) -> None:
        """Free the rungs' CUDA graphs now, every shard's. A closed engine
        can live on in a reference cycle until a full garbage collection,
        and a graph freed there is freed in the middle of whatever
        dispatch the process is running. A later dispatch captures its
        rung again."""
        with _device_locks(self._lock_devices):
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
        """Bind the kernel libraries the cell assignment and the probe
        launch, so no request pays for them: from the program store when
        one is bound (exported there when it lacks them), else built once
        per machine; [] when none is launched."""
        names = (self.index_system.cell_kernel_libraries(self.device)
                 + self.kernel_libraries())
        if not names:
            return []
        from ..kernels import _build

        for name in names:
            if self._programs is not None:
                try:
                    self._bind_library(name)
                except Exception as e:  # lint: broad-except-ok (the store is an optimization: any failure in it leaves the library to the nvcc path below)
                    _telemetry.record(
                        "program_store_fallback", library=name,
                        error=repr(e)[:200],
                    )
                    self.aot_stats["fallback"] += 1
        _build.load_all(names)
        return names

    def warmup(self) -> dict:
        """Bind the kernel library, run every ladder rung once against the
        resident index (first launches, the caching allocator), then
        freeze the signature set. Returns ``{"buckets", "seconds",
        "signatures", "backend_compiles"}`` (nvcc builds started), plus
        ``"aot"`` (entries loaded, exported, fallen back) with a program
        store bound and ``"aot_gc"`` (superseded entries dropped) when the
        index is an epochal one's."""
        t0 = backend_compiles()
        with _telemetry.capture() as events, _trace.span(
            "dispatch.warmup", buckets=len(self.ladder.buckets),
            devices=1 if self.mesh is None else self.mesh.size,
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
        if self._programs is not None:
            out["aot"] = dict(self.aot_stats)
            em = self._epoch_meta()
            if em:
                # this core IS the current epoch: entries exported for
                # earlier epochs of its series can never be loaded again
                out["aot_gc"] = self._programs.gc_superseded(
                    em["index_series"], em["index_epoch"]
                )
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
    """The process-cached :class:`DispatchCore` for an (index,
    placement, static arguments) combination: repeated
    `pip_join(mesh=...)` calls reuse one core. The cache holds the index
    strongly, so the ``id(index)`` part of the key cannot be recycled
    while the entry lives."""
    mesh = resolve_mesh(mesh, device=index.device)
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
            cell_dtype=cell_dtype, mesh=mesh,
        )
        _BATCH_CORES.put(key, core)
    return core
