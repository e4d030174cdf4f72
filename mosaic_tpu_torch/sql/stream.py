"""Streaming join pipeline: a device-resident batch ring + in-order
cell-assignment prefetch.

Port of ``mosaic_tpu/sql/stream.py``. Three pieces, all CPU-testable and
bit-identical to the per-batch path:

- **Ring** — K point batches stacked into one (K, B, 2) f64 tensor on
  the stream's device that the loop cycles (`ring_from_host` /
  `ring_from_generator`). Generator cost moves OUT of the measured loop;
  `generator_rate` prices it separately.
- **Prefetch** — iteration i joins batch i with the cells computed in
  iteration i-1 and computes batch i+1's cells. Cell assignment is
  deterministic, so this changes scheduling, never values. Both stages
  are queued in order on the caller's one CUDA stream (overlapping them
  on a side stream is later work).
- **Accounting** — every stage emits a `stream_stage` telemetry event
  with measured wall seconds, and :func:`hbm_peak` reports the loop's
  high-water device memory (``torch.cuda.max_memory_allocated`` on the
  card, a census of the stream's tensors on the CPU — never 0).

Completion is forced by :func:`fold_stats` — a device-side (checksum,
matches, overflow) fold, so no per-point data crosses to the host inside
a measured region. The loop is a Python loop over ring slots whose join
and fold read nothing back to the host: the one pull is the final (3,)
fold. With H3 the cell assignment runs on the device too (on the card
one kernel, `kernels/h3.py`), keeps its constant tables there and reads
nothing back, so a warm loop queues its batches without a host sync;
`chip_smoke.py` counts the syncs torch's sync debug mode reports in it (a
lower bound: the mode is a prototype) and fails on any. The custom grid
and BNG assign cells on the host, so their loop copies each batch there
and back.

The fold is exact int32 arithmetic, as the reference's: each batch's
terms are summed in int64 on the device and wrapped to the int32
two's-complement value (:func:`_wrap_i32` on the host, the same bit
arithmetic on the device), so no CUDA kernel relies on signed int32
overflow and segmenting a run never changes its stats.

Durability: :meth:`StreamJoin.run_durable` runs the loop in segments of
``snapshot_every`` ring cycles, snapshotting the carry (fold
accumulators, ring cursor, prefetched cell ids, optional extra arrays)
to a checksummed run directory (`runtime/checkpoint.py`, the reference's
layout) between segments; :meth:`StreamJoin.resume` restarts from the
last valid snapshot and converges to the SAME final (checksum, matches,
overflow) as an uninterrupted run. Every blocking device operation sits
under a `runtime/watchdog.py` deadline with transient retry
(`dispatch.guarded_call` at the ``stream.prefetch`` /
``stream.scan_step`` / ``stream.snapshot`` sites). A segment that
exhausts its retries on the CPU is answered by the f64 host oracle
(``metrics["degraded"]``); on the card it raises
:class:`~mosaic_tpu_torch.runtime.RetryExhausted` — no work moves to the
CPU. :meth:`StreamJoin.admit` diverts poisoned input rows (NaN/Inf,
out-of-bounds) into a quarantine buffer (`runtime/quarantine.py`).

What differs from the reference, and why:

- there is no compile: :class:`StreamPrograms` is a plain bundle of
  functions, which `StreamJoin` takes from ``dispatch.stream_programs``,
  the registered process-wide cache (two joins of one spec share one
  bundle; ``dispatch.cache_stats`` counts its hits); the durable loop
  loads the kernel library under a ``dispatch.compile`` span before its
  first segment, so a first build is never booked to a segment;
- ``donate_ring`` is accepted and changes nothing: the port never frees
  the caller's tensor (``metrics["ring_donated"]`` is False);
- ``mesh=`` (or the ``MOSAIC_MESH`` knob) shards the probe data
  parallel over a `parallel.mesh.Mesh` inside the loop, the index
  replicated (placed once a distinct device): bit for bit the
  single-device stream; the batch must divide over the mesh. ``lookup``
  and ``compaction`` default to the lanes `pip_join_points` runs
  (``gather``, ``scatter``) on every device;
- `ring_from_generator` takes seeds for ``torch.Generator`` (one a
  slot): its points cannot equal ``jax.random``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..dispatch import core as _dispatch, pipeline as _pipeline
from ..obs import metrics as _metrics, trace as _trace
from ..parallel import mesh as _mesh
from ..runtime import (
    checkpoint as _checkpoint,
    faults as _faults,
    quarantine as _quarantine,
    telemetry as _telemetry,
)
from ..runtime.errors import EpochFingerprintMismatch, RetryExhausted
from ..tune import resolve as _tune_resolve
from .join import (
    ChipIndex,
    host_join_with_cells,
    pip_join_points,
    resolve_probe_mode,
)

__all__ = [
    "StreamJoin",
    "StreamPrograms",
    "StreamResult",
    "build_stream_programs",
    "fold_stats",
    "fold_stats_np",
    "generator_rate",
    "hbm_peak",
    "ring_from_generator",
    "ring_from_host",
]

_I32_OFF = 1 << 31
_U32_MASK = (1 << 32) - 1


def _wrap_dev(v: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> its int32 two's-complement values, still int64 —
    the device twin of :func:`_wrap_i32` (bit arithmetic, no overflow)."""
    return ((v + _I32_OFF) & _U32_MASK) - _I32_OFF


def _fold_terms(out: torch.Tensor) -> torch.Tensor:
    """(3,) int64 unwrapped fold terms of one batch: the XOR-shift
    checksum sum (``>>`` on int32 is arithmetic, as in XLA), the match
    count and the overflow count."""
    o = out.to(torch.int32)
    return torch.stack([
        (o ^ (o >> 16)).sum(dtype=torch.int64),
        (o >= 0).sum(dtype=torch.int64),
        (o == -2).sum(dtype=torch.int64),
    ])


def fold_stats(out: torch.Tensor) -> torch.Tensor:
    """(3,) int32 device-side completion fold of a join output: full-bit
    XOR-shift checksum (every result bit stays live), match count,
    overflow count — each the int32 value the reference's fold gives."""
    return _wrap_dev(_fold_terms(out)).to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def ring_from_host(batches, device=None) -> torch.Tensor:
    """Stack host point batches into one (K, B, 2) f64 ring on ``device``
    (the card unless ``device="cpu"``; no card raises
    :class:`~mosaic_tpu_torch.DeviceUnavailable`). Blocks until the ring
    is staged (staging is not loop time). ``stream.prefetch`` is the
    fault/watchdog site."""
    dev = resolve_device(device)
    with _trace.span(
        "stream.ring_build", source="host"
    ) as sp, _telemetry.timed(
        "stream_stage", stage="ring_build", source="host"
    ):

        def stage():
            ring = torch.stack([
                torch.from_numpy(np.asarray(b, dtype=np.float64)) for b in batches
            ]).to(dev)
            _sync(dev)
            return ring

        # watchdog only — ring staging has no retry budget of its own;
        # the caller owns rebuild-vs-fail
        ring = _dispatch.guarded_call("stream.prefetch", stage, retry=False)
        sp.set(nbytes=ring.numel() * ring.element_size())
        return ring


def _slot_generators(key, k: int, device: torch.device):
    """One seeded ``torch.Generator`` a ring slot: slot i draws from seed
    ``key + i`` (``key`` an int, or a generator's initial seed)."""
    seed = key.initial_seed() if isinstance(key, torch.Generator) else int(key)
    gens = []
    for i in range(k):
        g = torch.Generator(device=device)
        g.manual_seed(seed + i)
        gens.append(g)
    return gens


def ring_from_generator(gen, key, k: int, device=None) -> torch.Tensor:
    """Device-generated ring: ``gen(generator) -> (B, 2)`` tensor for K
    slots, slot i drawing from its own generator seeded ``key + i``
    (``key`` an int or a ``torch.Generator``), stacked on ``device``."""
    dev = resolve_device(device)
    with _trace.span(
        "stream.ring_build", source="device_gen", k=k
    ) as sp, _telemetry.timed(
        "stream_stage", stage="ring_build", source="device_gen", k=k
    ):

        def stage():
            ring = torch.stack([
                gen(g).to(device=dev, dtype=torch.float64)
                for g in _slot_generators(key, k, dev)
            ])
            _sync(dev)
            return ring

        ring = _dispatch.guarded_call("stream.prefetch", stage, retry=False)
        sp.set(nbytes=ring.numel() * ring.element_size())
        return ring


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(getattr(a, "nbytes", 0))


def hbm_peak(device=None, fallback_arrays=()) -> tuple[int, str]:
    """(peak_bytes, source) for ``device`` (default: the card).

    On the card: ``torch.cuda.max_memory_allocated`` (the caching
    allocator's high-water mark). Elsewhere, or when that reads 0: a
    census of the tensors passed in ``fallback_arrays`` (the ring, the
    index and the loop's carries are resident at the high-water point,
    so this lower-bounds the true peak) — never a silent 0 for a stream
    that holds its ring.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        v = int(torch.cuda.max_memory_allocated(dev))
        if v > 0:
            src = "torch.cuda.max_memory_allocated"
            _metrics.gauge("stream.hbm_peak_bytes").set(v, source=src)
            return v, src
    total = sum(_nbytes(a) for a in fallback_arrays)
    _metrics.gauge("stream.hbm_peak_bytes").set(total, source="live_buffer_census")
    return total, "live_buffer_census"


@dataclasses.dataclass
class StreamResult:
    """One streamed run: device-fold stats + wall-clock accounting.

    ``metrics`` is the durability/quality side channel: ``degraded``
    (any segment answered by the host oracle), ``degraded_segments``,
    ``snapshots`` written, ``resumed_from`` (ring cursor a resume
    started at, else None), and the quarantine counters when admission
    ran (``quarantined``, ``quarantine_reasons``). Plain runs carry an
    empty dict — absence of a key is never a signal.
    """

    checksum: int
    matches: int
    overflow: int
    n_points: int
    n_batches: int
    batch: int
    wall_s: float
    points_per_sec: float
    prefetch: bool
    outs: np.ndarray | None = None  # (nb, B) per-batch rows (collect=True)
    metrics: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class StreamPrograms:
    """The function bundle behind one StreamJoin spec. Every callable
    takes the ChipIndex as an argument, so one bundle serves every index:
    `StreamJoin` takes it from ``dispatch.stream_programs``, the
    process-wide cache keyed by the spec. There is no compile behind it;
    sharing saves the closures and keeps one cache surface."""

    assign: object  #: (pts) -> int64 cells
    join: object  #: (pts, cells, index) -> rows
    step: object  #: assign + join (pts, index) -> rows
    step_stats: object  #: step, device-folded to (3,) stats
    loop: object  #: (ring, index, nb, collect) -> (acc, outs)
    seg_loop: object  #: durable segment over absolute batch indices


def build_stream_programs(
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
) -> StreamPrograms:
    """The StreamJoin program set for one static spec.

    ``mesh`` (a `parallel.mesh.Mesh`, or None) shards the probe data
    parallel with the ChipIndex replicated: ``join`` then takes the index
    as placed by `parallel.mesh.replicas` (or as it is), and each
    per-point result depends only on that point and the index, so the
    sharded stream equals the single-device one bit for bit.

    ``seg_loop(ring, index, i0, acc, cells, nb, collect)`` runs batches
    ``[i0, i0 + nb)`` (ring slot ``i % K``) and returns the new ``(acc,
    cells, outs)``: with ``prefetch`` batch i is joined against the
    ``cells`` carried in and the next batch's cells are carried out —
    including one assign past the last batch, the carry a snapshot
    stores for `resume`. ``acc`` is a (3,) int64 device tensor holding
    int32 values; nothing in the loop reads a value back to the host.

    While stage timing is on (`obs/trace.py`), each ``assign`` and
    ``join`` of the loop is a ``stream.assign`` / ``stream.join`` stage
    span, device-timed (not on a mesh) and read when `StreamJoin.run`
    pulls its fold; under `run_durable` and `compile` they are plain
    spans.
    """

    def assign(pts):
        c = index_system.point_to_cell(pts.to(cell_dtype), resolution)
        return c.to(torch.int64)

    def join_one(pts, cells, chip_index):
        shifted = (pts - chip_index.border.shift).to(dtype)
        return pip_join_points(
            shifted,
            cells,
            chip_index,
            heavy_cap=heavy_cap,
            found_cap=found_cap,
            lookup=lookup,
            compaction=compaction,
            probe=probe,
            convex_cap=convex_cap,
        )

    join = (
        join_one if mesh is None
        else _dispatch.sharded_pointwise(join_one, mesh)
    )

    def timed(ring):
        """The device a stage of ``ring``'s loop is timed on: none for a
        sharded probe, which runs on every device of the mesh."""
        return ring.device if mesh is None else None

    def seg(ring, chip_index, i0: int, acc, cells, nb: int, collect: bool):
        k, b, dev = ring.shape[0], ring.shape[1], timed(ring)
        outs = []
        for i in range(int(i0), int(i0) + nb):
            if prefetch:
                # join batch i against the cells prefetched at i-1;
                # assign batch i+1's cells in the same pass
                with _trace.stage_span("stream.join", device=dev, points=b):
                    out = join(ring[i % k], cells, chip_index)
                with _trace.stage_span("stream.assign", device=dev, points=b):
                    cells = assign(ring[(i + 1) % k])
            else:
                pts = ring[i % k]
                with _trace.stage_span("stream.assign", device=dev, points=b):
                    pts_cells = assign(pts)
                with _trace.stage_span("stream.join", device=dev, points=b):
                    out = join(pts, pts_cells, chip_index)
            acc = _wrap_dev(acc + _fold_terms(out))
            if collect:
                outs.append(out)
        return acc, cells, (torch.stack(outs) if collect and outs else None)

    def loop(ring, chip_index, nb: int, collect: bool):
        acc0 = torch.zeros(3, dtype=torch.int64, device=ring.device)
        if prefetch:
            with _trace.stage_span(
                "stream.assign", device=timed(ring), points=ring.shape[1]
            ):
                cells0 = assign(ring[0])
        else:
            cells0 = torch.zeros(0, dtype=torch.int64, device=ring.device)
        acc, _cells, outs = seg(ring, chip_index, 0, acc0, cells0, nb, collect)
        return acc, outs

    def step(pts, ix):
        return join(pts, assign(pts), ix)

    return StreamPrograms(
        assign=assign,
        join=join,
        step=step,
        # step + fold: benches time THIS (one (3,) pull forces
        # completion; pulling the (N,) rows would measure the copy)
        step_stats=lambda pts, ix: fold_stats(step(pts, ix)),
        loop=loop,
        seg_loop=seg,
    )


def _uses_kernel(probe: str, index: ChipIndex) -> bool:
    """Does the probe launch ``pip_heavy_tiled`` on this index?"""
    return (
        probe in ("adaptive", "adaptive-heavy")
        and index.num_heavy_cells > 0
        and index.heavy_edges.dtype == torch.float32
    )


class StreamJoin:
    """Streaming pip-join over a resident ring, on the index's device.

    Splits the fused step into its two stages — ``assign`` (grid cell
    ids) and ``join`` (the PIP probe) — and runs one loop that cycles
    ring slots with optional prefetch of the next batch's cells. ``run``
    (prefetch on) is bit-identical to ``run_batched`` (one call per
    batch, no pipeline) — pinned by tests/test_torch_stream.py. The
    stream's tensors live on its index's device; a ring elsewhere is
    refused. ``found_cap``/``heavy_cap``/``convex_cap`` bound the probe's
    compactions as in `pip_join_points` (None = the batch size, exact);
    points past a cap return -2 and count in ``overflow``.
    """

    def __init__(
        self,
        index: ChipIndex,
        index_system,
        resolution: int,
        *,
        found_cap: int | None = None,
        heavy_cap: int | None = None,
        lookup: str | None = None,
        compaction: str | None = None,
        cell_dtype=torch.float32,
        prefetch: bool = True,
        probe: "str | None" = None,
        convex_cap: int | None = None,
        donate_ring: bool = False,
        mesh=None,
        profile=None,
    ):
        #: the TuningProfile consulted again at run_durable/resume time
        #: for the pipeline/window knobs (same precedence as here)
        self._profile = profile
        # profile-consumed knobs fold at this host entry point: explicit
        # arg > env knob > profile > built-in default (tune/resolve.py)
        knobs = _tune_resolve.resolve_knobs(
            "stream_join", profile,
            explicit={"probe": probe, "lookup": lookup},
            defaults={"probe": "scatter", "lookup": None},
        )
        probe, lookup = knobs["probe"], knobs["lookup"]
        self.index = index
        self.index_system = index_system
        self.resolution = resolution
        self.device = index.device
        self.prefetch = bool(prefetch)
        self.donate_ring = bool(donate_ring)
        #: (ring fingerprint, report) of the last admission, if any
        self._last_quarantine: tuple | None = None
        self.lookup = lookup or "gather"
        self.compaction = compaction or "scatter"
        self.found_cap, self.heavy_cap = found_cap, heavy_cap
        # the force-lane knob resolves here, at the host entry point
        self.probe = resolve_probe_mode(probe)
        self.convex_cap = convex_cap
        # placement resolves here too, once: the programs close over it
        self.mesh = _dispatch.resolve_mesh(mesh, device=self.device)
        #: what the loop probes: the index, or its placement on the mesh
        self._probe_index = (
            index if self.mesh is None
            else _mesh.replicas(index, self.mesh)
        )
        progs = _dispatch.stream_programs(
            index_system, resolution, dtype=index.border.verts.dtype,
            cell_dtype=cell_dtype, found_cap=found_cap, heavy_cap=heavy_cap,
            lookup=self.lookup, compaction=self.compaction, probe=self.probe,
            convex_cap=convex_cap, prefetch=self.prefetch, mesh=self.mesh,
        )
        self._programs = progs
        self.assign = progs.assign
        self.join = progs.join
        self._loop = progs.loop
        self._seg_loop = progs.seg_loop
        self._loaded = False

    def _check_ring(self, ring: torch.Tensor) -> tuple[int, int]:
        if ring.device.type != self.device.type:
            raise ValueError(
                f"the ring lives on {ring.device}, the stream runs on "
                f"{self.device}: stage it with ring_from_host(..., "
                f"device={str(self.device)!r})"
            )
        self._check_batch(ring.shape[1])
        return int(ring.shape[0]), int(ring.shape[1])

    def _check_batch(self, batch: int) -> None:
        if self.mesh is not None and int(batch) % self.mesh.size:
            raise ValueError(
                f"stream batch {int(batch)} does not divide over the "
                f"{self.mesh.size}-device mesh"
            )

    def step(self, pts: torch.Tensor) -> torch.Tensor:
        """Single batch (assign + join) — the single-batch-rate reference
        the sustained number is measured against."""
        self._check_batch(pts.shape[0])
        return self._programs.step(pts, self._probe_index)

    def step_stats(self, pts: torch.Tensor) -> torch.Tensor:
        """Single batch, device-folded to (3,) stats."""
        self._check_batch(pts.shape[0])
        return self._programs.step_stats(pts, self._probe_index)

    def _load_kernels(self) -> list[str]:
        """Build/bind the kernel libraries the cell assignment and the
        probe launch (on the card, once per stream); returns the libraries
        loaded by this call."""
        if self._loaded or self.device.type != "cuda":
            return []
        self._loaded = True
        names = list(self.index_system.cell_kernel_libraries(self.device))
        if _uses_kernel(self.probe, self.index):
            names.append("pip")
        from ..kernels import _build

        _build.load_all(names)
        return names

    def compile(self, ring: torch.Tensor, n_batches: int, collect=False):
        """Warm the loop: load the kernel library and run the loop once
        (first launches, allocator), so a sustained measurement starts
        warm; emits a ``stream_stage`` compile event. Returns the loop's
        ``(acc, outs)`` device tensors."""
        self._check_ring(ring)
        with _telemetry.timed(
            "stream_stage", stage="compile", n_batches=n_batches,
            prefetch=self.prefetch, donate_ring=self.donate_ring,
        ):
            self._load_kernels()
            acc, outs = self._loop(ring, self._probe_index, n_batches, collect)
            _sync(self.device)
        return acc, outs

    def run(
        self, ring: torch.Tensor, n_batches: int, *, collect: bool = False
    ) -> StreamResult:
        """One timed streamed pass over ``n_batches`` ring cycles.

        With H3 cells the whole stream is queued without a host sync;
        completion is forced by pulling the (3,) fold. With ``donate_ring`` the metrics
        record ``ring_donated: False`` — the port keeps the caller's ring.
        """
        k, batch = self._check_ring(ring)
        donation = {}
        with _trace.span(
            "stream.run", n_batches=n_batches, batch=batch, ring_k=k,
        ), _trace.device_stages():
            t0 = time.perf_counter()
            acc, outs = self._loop(ring, self._probe_index, n_batches, collect)
            with _trace.stage_span("stream.fold_pull"):
                acc_np = acc.cpu().numpy()  # blocks: the loop's only host pull
            wall = time.perf_counter() - t0
            n_points = n_batches * batch
            if self.donate_ring:
                donation = {
                    "donate_ring": True,
                    "ring_donated": False,
                    "ring_bytes": _nbytes(ring),
                }
            _telemetry.record(
                "stream_stage", stage="join_loop",
                seconds=round(wall, 6), n_batches=n_batches, batch=batch,
                ring_k=k, prefetch=self.prefetch,
                points_per_sec=round(n_points / max(wall, 1e-9), 1),
                **donation,
            )
        return StreamResult(
            checksum=int(acc_np[0]),
            matches=int(acc_np[1]),
            overflow=int(acc_np[2]),
            n_points=n_points,
            n_batches=n_batches,
            batch=batch,
            wall_s=wall,
            points_per_sec=n_points / max(wall, 1e-9),
            prefetch=self.prefetch,
            outs=outs.cpu().numpy() if collect and outs is not None else None,
            metrics=dict(donation),
        )

    def run_batched(self, ring: torch.Tensor, n_batches: int) -> StreamResult:
        """Per-batch reference path: one ``step`` call per ring slot, no
        pipeline, host-accumulated stats — the bit-identity oracle for
        the loop (and the honest non-overlapped comparison)."""
        k, batch = self._check_ring(ring)
        outs, acc = [], np.zeros(3, np.int64)
        t0 = time.perf_counter()
        for i in range(n_batches):
            out = self.step(ring[i % k])
            outs.append(out.cpu().numpy())
            acc += fold_stats(out).cpu().numpy().astype(np.int64)
        wall = time.perf_counter() - t0
        n_points = n_batches * batch
        return StreamResult(
            checksum=int(_wrap_i32(acc[0])),
            matches=int(acc[1]),
            overflow=int(acc[2]),
            n_points=n_points,
            n_batches=n_batches,
            batch=batch,
            wall_s=wall,
            points_per_sec=n_points / max(wall, 1e-9),
            prefetch=False,
            outs=np.stack(outs),
        )

    # ------------------------------------------------------ durability

    def admit(
        self,
        batches,
        *,
        bounds: tuple | None = None,
        park: np.ndarray | None = None,
    ) -> "tuple[torch.Tensor, _quarantine.QuarantineReport]":
        """Validate and stage host batches into a ring on the stream's
        device; poisoned rows go to quarantine, never to the device fold.

        Each batch is scrubbed (`runtime/quarantine.py`): non-finite
        rows, and rows outside ``bounds`` (xmin, ymin, xmax, ymax) when
        given, are recorded in the returned
        :class:`~mosaic_tpu_torch.runtime.quarantine.QuarantineReport`
        (their raw values land in ``report.buffer``) and replaced in the
        staged ring by the stream's *park point* — a coordinate proven
        here to hit no indexed cell, so every parked row returns -1 and
        contributes exactly zero to each fold statistic. Admitted rows
        are staged bit-identically; the ring is otherwise exactly
        :func:`ring_from_host`'s. The report's counters surface in
        ``metrics`` of subsequent :meth:`run_durable` calls on this ring.
        """
        batches = list(batches)  # materialize once (may be a generator)
        with _trace.span("stream.admit", batches=len(batches)):
            return self._admit_scrubbed(batches, bounds, park)

    def _admit_scrubbed(self, batches, bounds, park):
        raws = [
            np.asarray(
                _faults.maybe_corrupt("stream.admit", b), dtype=np.float64
            )
            for b in batches
        ]
        report = _quarantine.QuarantineReport()
        park_pt = (
            None if park is None else np.asarray(park, dtype=np.float64)
        )
        cleaned = []
        for bi, raw in enumerate(raws):
            bad, reasons = _quarantine.scrub_points(raw, bounds=bounds)
            report.merge_batch(bi, raw, bad, reasons)
            if bad.any():
                if park_pt is None:
                    park_pt = self._find_park(raws, bounds)
                clean = raw.copy()
                clean[bad] = park_pt
                cleaned.append(clean)
            else:
                cleaned.append(raw)
        ring = ring_from_host(cleaned, device=self.device)
        if report.n_quarantined:
            _telemetry.record("stream_quarantine", **report.metrics())
        # keyed by ring fingerprint: run_durable only surfaces this
        # report for the ring THIS admission staged, never a stale one
        self._last_quarantine = (_checkpoint.fingerprint(np.stack(cleaned)), report)
        return ring, report

    def _find_park(self, raws, bounds) -> np.ndarray:
        """The guaranteed-miss park coordinate (see ``admit``)."""
        if bounds is None:
            finite = [r[np.isfinite(r).all(axis=1)] for r in raws]
            finite = [f for f in finite if f.size]
            allp = (
                np.concatenate(finite)
                if finite
                else np.zeros((1, 2), np.float64)
            )
            bounds = (
                float(allp[:, 0].min()), float(allp[:, 1].min()),
                float(allp[:, 0].max()), float(allp[:, 1].max()),
            )

        def assign_host(p):
            pts = torch.from_numpy(np.asarray(p, np.float64)).to(self.device)
            return self.assign(pts).cpu().numpy()

        return _quarantine.find_park_point(
            assign_host, self.index.cells.cpu().numpy(), bounds,
        )

    def _warm_seg_loop(self) -> None:
        """Load the kernel library BEFORE the segment loop starts, under a
        ``dispatch.compile`` span, so a first build (nvcc, seconds) is
        never booked to ``stream.segment[0]``'s device time. Nothing is
        compiled per shape in the port, so there is nothing else to warm
        and no compile count to report."""
        if self._loaded or self.device.type != "cuda":
            return
        with _trace.span("dispatch.compile", site="stream.seg_loop") as sp:
            sp.set(libraries=repr(self._load_kernels()))

    def _host_segment(self, ring_np, i0: int, nb: int, collect: bool):
        """f64 host-oracle evaluation of batches [i0, i0+nb) — the
        degradation answer (CPU only) when a segment's device path fails
        past the retry budget. Returns ((3,) int64 fold delta, outs |
        None)."""
        host = self.index.host
        k = ring_np.shape[0]
        acc = np.zeros(3, np.int64)
        outs = []
        for i in range(i0, i0 + nb):
            pts = np.asarray(ring_np[i % k], np.float64)
            cells = np.asarray(
                self.index_system.point_to_cell(pts, self.resolution)
            )
            out = host_join_with_cells(pts, cells, host)
            acc += fold_stats_np(out)
            if collect:
                outs.append(out)
        return acc, (np.stack(outs) if collect else None)

    def _degrades(self) -> bool:
        """Past the retry budget a segment degrades to the host oracle only
        on the CPU; on the card the error propagates."""
        return (
            getattr(self.index, "host", None) is not None
            and self.device.type == "cpu"
        )

    def run_durable(
        self,
        ring: torch.Tensor,
        n_batches: int,
        *,
        run_dir: str,
        snapshot_every: int = 8,
        collect: bool = False,
        extra_arrays: dict | None = None,
        watchdog_default_s: float = 600.0,
        retry_policy=None,
        pipeline: "bool | None" = None,
        window: "int | None" = None,
    ) -> StreamResult:
        """A streamed pass that survives device loss: the loop runs in
        segments of ``snapshot_every`` ring cycles, persisting the carry
        (fold accumulators, ring cursor, prefetched cell ids, any
        ``extra_arrays``) to ``run_dir`` after each segment
        (`runtime/checkpoint.py`: checksummed, atomic).

        ``pipeline=True`` (default: the ``MOSAIC_STREAM_PIPELINE`` knob)
        runs the segments through the pipelined executor
        (`dispatch/pipeline.py`): the fold accumulator and prefetched
        cells stay on the device across segments, up to ``window``
        segments (``MOSAIC_STREAM_WINDOW``, default 4) are in flight at
        once, and snapshot I/O runs on a background writer thread.
        Bit-identical to the synchronous loop, and the durability
        contract is unchanged: a snapshot is durable only once its
        background write completes, and resume replays from the last
        *completed* snapshot.

        Identical final (checksum, matches, overflow) to :meth:`run`.
        Each segment runs under the ``stream.scan_step`` watchdog
        deadline and the transient-retry budget; past the budget a
        segment on the CPU degrades to the f64 host oracle
        (``metrics["degraded"]``), and one on the card raises
        :class:`RetryExhausted`. Snapshot failures never kill the run
        (``snapshot_skipped`` telemetry; resume granularity coarsens).
        Interrupt anywhere and :meth:`resume` (``run_dir``, same ring)
        finishes the run.

        Tracing: the whole run is one ``stream.durable_run`` span with
        one child per segment and snapshot; the span's context is
        persisted in every snapshot sidecar, so a later :meth:`resume`
        JOINS the interrupted run's trace.
        """
        return self._run_segments(
            ring, int(n_batches), run_dir=run_dir,
            snapshot_every=int(snapshot_every), start_step=0,
            acc0=None, cells0=None, collect=collect,
            resumed_from=None, extra_arrays=extra_arrays,
            watchdog_default_s=watchdog_default_s,
            retry_policy=retry_policy,
            pipeline=pipeline, window=window,
        )

    def resume(
        self,
        run_dir: str,
        ring: torch.Tensor,
        *,
        collect: bool = False,
        watchdog_default_s: float = 600.0,
        retry_policy=None,
        pipeline: "bool | None" = None,
        window: "int | None" = None,
    ) -> StreamResult:
        """Restart an interrupted :meth:`run_durable` from the last
        VALID snapshot in ``run_dir`` (corrupt/truncated snapshots are
        skipped with telemetry) and run to completion.

        The snapshot's ring fingerprint, shape, and prefetch mode must
        match this stream, and its index identity this stream's index
        (:class:`EpochFingerprintMismatch` otherwise). Converges to the
        same final (checksum, matches, overflow) as the uninterrupted
        run; ``metrics["resumed_from"]`` records the ring cursor resumed
        at. With ``collect=True``, ``outs`` covers only the batches run
        by THIS call. A run directory written by the reference package
        resumes here too (same layout, same fingerprints).
        """
        loaded = _checkpoint.load_latest(run_dir)
        if loaded is None:
            raise FileNotFoundError(
                f"no valid snapshot under {run_dir!r} — nothing to resume"
            )
        step, arrays, meta = loaded
        k, batch = self._check_ring(ring)
        if bool(meta.get("prefetch")) != self.prefetch:
            raise ValueError(
                f"snapshot prefetch={meta.get('prefetch')} != stream "
                f"prefetch={self.prefetch}"
            )
        if int(meta.get("ring_k", k)) != k or int(
            meta.get("batch", batch)
        ) != batch:
            raise ValueError(
                f"snapshot ring shape ({meta.get('ring_k')}, "
                f"{meta.get('batch')}) != resumed ring ({k}, {batch})"
            )
        ring_np = ring.cpu().numpy()
        ring_fp = _checkpoint.fingerprint(ring_np)
        want_fp = meta.get("ring_sha256")
        if want_fp and want_fp != ring_fp:
            raise ValueError(
                "snapshot ring fingerprint mismatch — this is not the "
                "ring the interrupted run was folding"
            )
        want_idx = meta.get("index_identity")
        have_idx = _checkpoint.index_identity(self.index)
        if want_idx and want_idx != have_idx:
            # folding batches joined against one index into accumulators
            # from another would be a silent wrong answer
            raise EpochFingerprintMismatch(
                f"snapshot under {run_dir!r} was taken against index "
                f"{want_idx[:24]}…, but this stream is bound to "
                f"{have_idx[:24]}… — rebuild the stream on the "
                "snapshot's epoch (EpochalIndex.replay of the matching "
                "epoch) to finish this run, or start a fresh run on "
                "the new epoch",
                expected=want_idx, actual=have_idx,
            )
        cells0 = (
            torch.from_numpy(np.asarray(arrays["cells"], np.int64)).to(self.device)
            if "cells" in arrays else None
        )
        return self._run_segments(
            ring, int(meta["n_batches"]), run_dir=run_dir,
            snapshot_every=int(meta.get("snapshot_every", 8)),
            start_step=int(step),
            acc0=np.asarray(arrays["acc"], np.int64),
            cells0=cells0, collect=collect, resumed_from=int(step),
            extra_arrays={
                key[2:]: val
                for key, val in arrays.items()
                if key.startswith("x_")
            } or None,
            watchdog_default_s=watchdog_default_s,
            retry_policy=retry_policy,
            trace_parent=_trace.SpanContext.from_dict(meta.get("trace")),
            pipeline=pipeline, window=window,
            ring_np=ring_np, ring_fp=ring_fp,
        )

    def _run_segments(
        self, ring, n_batches, *, run_dir, snapshot_every, start_step,
        acc0, cells0, collect, resumed_from, extra_arrays,
        watchdog_default_s, retry_policy, trace_parent=None,
        pipeline=None, window=None, ring_np=None, ring_fp=None,
    ) -> StreamResult:
        k, batch = self._check_ring(ring)
        snapshot_every = max(1, snapshot_every)
        # mode knobs resolved at call time:
        # explicit arg > MOSAIC_STREAM_PIPELINE/_WINDOW > profile > default
        knobs = _tune_resolve.resolve_knobs(
            "stream_join.run_durable", self._profile,
            explicit={"stream_pipeline": pipeline, "stream_window": window},
            defaults={"stream_pipeline": False, "stream_window": None},
        )
        pipeline, window = knobs["stream_pipeline"], knobs["stream_window"]
        if ring_np is None:
            ring_np = ring.cpu().numpy()  # host twin: fingerprint + fallback
            ring_fp = _checkpoint.fingerprint(ring_np)
        # one root span per durable run; a resume parents to the
        # INTERRUPTED run's root (persisted in the snapshot sidecars),
        # so kill + resume reads as one trace end to end
        root = _trace.start_span(
            "stream.durable_run",
            parent=trace_parent,
            n_batches=int(n_batches),
            resumed_from=resumed_from,
            snapshot_every=int(snapshot_every),
            pipelined=bool(pipeline),
        )
        runner = (
            self._run_segments_pipelined if pipeline
            else self._run_segments_traced
        )
        kw = {"window": window} if pipeline else {}
        try:
            return runner(
                ring, n_batches, run_dir=run_dir,
                snapshot_every=snapshot_every, start_step=start_step,
                acc0=acc0, cells0=cells0, collect=collect,
                resumed_from=resumed_from, extra_arrays=extra_arrays,
                watchdog_default_s=watchdog_default_s,
                retry_policy=retry_policy, root=root,
                ring_np=ring_np, ring_fp=ring_fp, k=k, batch=batch,
                **kw,
            )
        except BaseException as e:  # noqa: BLE001 — stamped, re-raised
            root.set(error=type(e).__name__)
            raise
        finally:
            root.end()

    def _meta(self, n_batches, batch, k, snapshot_every, ring_fp, root) -> dict:
        return {
            "n_batches": int(n_batches),
            "batch": batch,
            "ring_k": k,
            "prefetch": self.prefetch,
            "snapshot_every": int(snapshot_every),
            "ring_sha256": ring_fp,
            "index_identity": _checkpoint.index_identity(self.index),
            "trace": root.context.as_dict(),
        }

    def _first_cells(self, ring, step, cells0):
        """The carry's cells at ``step``: the snapshot's, or assigned."""
        if not self.prefetch:
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        if cells0 is not None:
            return cells0
        return self.assign(ring[step % int(ring.shape[0])])

    def _result(
        self, acc, n_batches, batch, k, start_step, wall, snapshots,
        degraded_segments, resumed_from, run_dir, ring_fp, outs_list,
        collect, pstats=None,
    ) -> StreamResult:
        acc_w = _wrap_i32(acc)
        n_run = int(n_batches) - start_step
        extra = {} if pstats is None else {"pipelined": True, "window": pstats.window}
        _telemetry.record(
            "stream_stage", stage="durable_loop",
            seconds=round(wall, 6), n_batches=int(n_batches),
            batch=batch, ring_k=k, prefetch=self.prefetch,
            snapshots=snapshots, degraded_segments=degraded_segments,
            resumed_from=resumed_from, **extra,
            points_per_sec=round(n_run * batch / max(wall, 1e-9), 1),
        )
        metrics = {
            "degraded": degraded_segments > 0,
            "degraded_segments": degraded_segments,
            "snapshots": snapshots,
            "resumed_from": resumed_from,
            "run_dir": run_dir,
        }
        if pstats is not None:
            metrics["pipeline"] = pstats.as_dict()
        if (
            self._last_quarantine is not None
            and self._last_quarantine[0] == ring_fp
        ):
            metrics.update(self._last_quarantine[1].metrics())
        return StreamResult(
            checksum=int(acc_w[0]),
            matches=int(acc_w[1]),
            overflow=int(acc_w[2]),
            n_points=int(n_batches) * batch,
            n_batches=int(n_batches),
            batch=batch,
            wall_s=wall,
            points_per_sec=n_run * batch / max(wall, 1e-9),
            prefetch=self.prefetch,
            outs=(
                np.concatenate(outs_list)
                if collect and outs_list
                else None
            ),
            metrics=metrics,
        )

    def _snapshot(self, run_dir, step, acc, cells, extra_arrays, meta,
                  watchdog_default_s, retry_policy) -> bool:
        """Write one snapshot under the ``stream.snapshot`` guard; a write
        that exhausts its retries is skipped (``snapshot_skipped``) and
        the run goes on. Returns whether the snapshot was written."""

        def snap():
            payload = self._snapshot_payload(acc, cells, extra_arrays)
            return _checkpoint.save_snapshot(run_dir, step, payload, meta)

        try:
            _dispatch.guarded_call(
                "stream.snapshot", snap,
                default_s=watchdog_default_s, policy=retry_policy,
            )
            return True
        except RetryExhausted as e:
            # durability degrades (coarser resume point), the run itself
            # must not die for a sick disk
            _telemetry.record(
                "snapshot_skipped", run_dir=run_dir, step=step,
                error=repr(e.last)[:200],
            )
            return False

    def _run_segments_traced(
        self, ring, n_batches, *, run_dir, snapshot_every, start_step,
        acc0, cells0, collect, resumed_from, extra_arrays,
        watchdog_default_s, retry_policy, root, ring_np, ring_fp,
        k, batch,
    ) -> StreamResult:
        acc = (
            np.zeros(3, np.int64) if acc0 is None
            else _wrap_i32(np.asarray(acc0, np.int64))
        )
        cells = self._first_cells(ring, start_step, cells0)
        meta = self._meta(n_batches, batch, k, snapshot_every, ring_fp, root)
        degraded_segments = 0
        snapshots = 0
        outs_list: list[np.ndarray] = []
        # load the kernels up front, under a compile span — NOT inside
        # segment[0]'s device-attributed wall time
        self._warm_seg_loop()
        step = start_step
        t0 = time.perf_counter()
        while step < n_batches:
            seg_n = min(snapshot_every, n_batches - step)
            acc, cells, o_np, degr = self._segment_sync(
                ring, ring_np, step, seg_n, acc, cells,
                collect=collect, watchdog_default_s=watchdog_default_s,
                retry_policy=retry_policy,
            )
            degraded_segments += int(degr)
            if collect and o_np is not None:
                outs_list.append(o_np)
            step += seg_n
            with _trace.span("stream.snapshot", step=step):
                snapshots += self._snapshot(
                    run_dir, step, acc, cells, extra_arrays, meta,
                    watchdog_default_s, retry_policy,
                )
        wall = time.perf_counter() - t0
        return self._result(
            acc, n_batches, batch, k, start_step, wall, snapshots,
            degraded_segments, resumed_from, run_dir, ring_fp, outs_list,
            collect,
        )

    def _segment_sync(
        self, ring, ring_np, step, seg_n, acc, cells, *, collect,
        watchdog_default_s, retry_policy,
    ):
        """One synchronous durable segment: dispatch + blocking pull
        under the ``stream.scan_step`` guard, host-oracle degradation
        (CPU only) past the retry budget. Returns ``(acc int64, cells,
        outs | None, degraded)``. Shared by the synchronous loop and the
        pipelined executor's transient-replay path — replay IS the
        synchronous path, so its semantics cannot drift."""
        k = int(ring.shape[0])
        acc_dev = torch.from_numpy(_wrap_i32(acc)).to(self.device)
        cells_arg = cells

        def dispatch():
            a, c, o = self._seg_loop(
                ring, self._probe_index, step, acc_dev, cells_arg,
                nb=seg_n, collect=collect,
            )
            # one host pull forces completion (and is what a real stall
            # would block on)
            return (
                a.cpu().numpy(), c,
                o.cpu().numpy() if collect else None,
            )

        with _trace.span("stream.segment", step=step, n=seg_n):
            try:
                a_np, cells_new, o_np = _dispatch.guarded_call(
                    "stream.scan_step", dispatch,
                    default_s=watchdog_default_s,
                    policy=retry_policy,
                )
                return np.asarray(a_np, np.int64), cells_new, o_np, False
            except RetryExhausted as e:
                if not self._degrades():
                    raise
                _telemetry.record(
                    "degraded", label="stream.scan_step", step=step,
                    attempts=e.attempts, error=repr(e.last)[:200],
                )
                delta, o_np = self._host_segment(
                    ring_np, step, seg_n, collect
                )
                acc = _wrap_i32(np.asarray(acc, np.int64) + delta)
                if self.prefetch:
                    cells = self.assign(ring[(step + seg_n) % k])
                return acc, cells, o_np, True

    def _snapshot_payload(self, acc, cells, extra_arrays) -> dict:
        """The snapshot carry arrays, every device pull under a
        ``dispatch.transfer.d2h`` span (``cells`` AND the ``x_<key>``
        passthroughs)."""
        payload = {"acc": _wrap_i32(acc).astype(np.int32)}
        if self.prefetch and cells is not None:
            with _trace.span(
                "dispatch.transfer.d2h", site="stream.snapshot",
                nbytes=_nbytes(cells),
            ):
                payload["cells"] = _checkpoint.host_array(cells)
        for key, val in (extra_arrays or {}).items():
            with _trace.span(
                "dispatch.transfer.d2h", site="stream.snapshot",
                nbytes=_nbytes(val), key=key,
            ):
                payload[f"x_{key}"] = _checkpoint.host_array(val)
        return payload

    def _run_segments_pipelined(
        self, ring, n_batches, *, run_dir, snapshot_every, start_step,
        acc0, cells0, collect, resumed_from, extra_arrays,
        watchdog_default_s, retry_policy, root, ring_np, ring_fp,
        k, batch, window=None,
    ) -> StreamResult:
        """The asynchronous pipelined durable loop.

        Segment i+1 is queued while segment i still runs: the fold
        accumulator and prefetched cells chain device to device (no
        per-segment host round trip — bit-identical, the device fold IS
        the int32 wraparound `_wrap_i32` emulates), the blocking pull
        happens at the bounded window's drain, and the snapshot write
        (with its copy of the cells) runs on a
        `dispatch.pipeline.SnapshotWriter` thread. Transient failures at
        the drain replay through :meth:`_segment_sync` from the last
        materialized carry; degradation/watchdog/fault-injection
        semantics are the synchronous loop's (same ``stream.scan_step``
        / ``stream.snapshot`` sites)."""
        acc_host = (
            np.zeros(3, np.int64) if acc0 is None
            else _wrap_i32(np.asarray(acc0, np.int64))
        )
        cells_dev = self._first_cells(ring, start_step, cells0)
        acc_dev = torch.from_numpy(acc_host.copy()).to(self.device)
        meta = self._meta(n_batches, batch, k, snapshot_every, ring_fp, root)
        degraded = [0]
        counters = {"snapshots": 0}
        outs_list: list[np.ndarray] = []
        self._warm_seg_loop()
        bounds = [
            (s, min(snapshot_every, n_batches - s))
            for s in range(start_step, int(n_batches), snapshot_every)
        ]
        win = _pipeline.resolve_window(window)
        writer = _pipeline.SnapshotWriter(
            name="stream", maxsize=max(2, 2 * win)
        )
        # the replay anchor: last materialized (landed) host carry
        landed = {"acc": acc_host, "end": start_step}

        def submit_snapshot(se, acc, cells):
            def job(se=se, acc=np.asarray(acc, np.int64), cells=cells):
                with _trace.span("stream.snapshot", step=se, mode="async"):
                    counters["snapshots"] += self._snapshot(
                        run_dir, se, acc, cells, extra_arrays, meta,
                        watchdog_default_s, retry_policy,
                    )

            writer.submit(job)

        def launch(i):
            nonlocal acc_dev, cells_dev
            step, seg_n = bounds[i]
            a0, c0 = acc_dev, cells_dev

            def dispatch_async():
                # queued, not waited for: the blocking pull happens at
                # the window's drain
                return self._seg_loop(
                    ring, self._probe_index, step, a0, c0,
                    nb=seg_n, collect=collect,
                )

            with _trace.span(
                "stream.segment", step=step, n=seg_n, pipelined=True
            ):
                try:
                    a, c, o = _dispatch.guarded_call(
                        "stream.scan_step", dispatch_async,
                        default_s=watchdog_default_s,
                        policy=retry_policy,
                    )
                except RetryExhausted as e:
                    if not self._degrades():
                        raise
                    _telemetry.record(
                        "degraded", label="stream.scan_step",
                        step=step, attempts=e.attempts,
                        error=repr(e.last)[:200],
                    )
                    # the carry chain is deterministic: pulling the
                    # in-flight acc waits for upstream segments and
                    # yields the exact pre-segment fold
                    a_host = a0.cpu().numpy().astype(np.int64)
                    delta, o_np = self._host_segment(
                        ring_np, step, seg_n, collect
                    )
                    acc_new = _wrap_i32(a_host + delta)
                    acc_dev = torch.from_numpy(acc_new.copy()).to(self.device)
                    if self.prefetch:
                        cells_dev = self.assign(ring[(step + seg_n) % k])
                    return ("host", acc_new, cells_dev, o_np)
                acc_dev, cells_dev = a, c
                return ("dev", a, c, o)

        def land(i, handle):
            # runs under the drain watchdog, whose deadline ABANDONS the
            # worker thread — pulls only, no state mutation
            kind, a, c, o = handle
            if kind == "dev":
                a_np = a.cpu().numpy()  # blocks: the drain's one pull
                o_np = o.cpu().numpy() if collect else None
            else:
                a_np, o_np = a, o
            return (kind, a_np, o_np, c)

        def commit(i, pulled):
            kind, a_np, o_np, c = pulled
            step, seg_n = bounds[i]
            se = step + seg_n
            acc_w = _wrap_i32(np.asarray(a_np, np.int64))
            # submit before touching the anchor: a held writer error can
            # raise here, and the replay must then re-apply this segment
            # from the PRE-segment carry
            submit_snapshot(se, acc_w, c if self.prefetch else None)
            if kind == "host":
                # degradation counts at materialization, not launch
                degraded[0] += 1
            if collect and o_np is not None:
                outs_list.append(o_np)
            # the anchor update is the final statement
            landed["acc"] = acc_w
            landed["end"] = se

        def replay(lo, hi):
            nonlocal acc_dev, cells_dev
            acc = landed["acc"]
            step0 = bounds[lo][0]
            cells = self._first_cells(ring, step0, None)
            for j in range(lo, hi + 1):
                step, seg_n = bounds[j]
                acc, cells, o_np, degr = self._segment_sync(
                    ring, ring_np, step, seg_n, acc, cells,
                    collect=collect,
                    watchdog_default_s=watchdog_default_s,
                    retry_policy=retry_policy,
                )
                degraded[0] += int(degr)
                if collect and o_np is not None:
                    outs_list.append(o_np)
                landed["acc"] = _wrap_i32(np.asarray(acc, np.int64))
                landed["end"] = step + seg_n
                submit_snapshot(
                    landed["end"], landed["acc"],
                    cells if self.prefetch else None,
                )
            acc_dev = torch.from_numpy(landed["acc"].copy()).to(self.device)
            cells_dev = cells

        t0 = time.perf_counter()
        try:
            pstats = _pipeline.execute_pipeline(
                len(bounds), launch, land,
                drain_site="stream.pipeline.drain", commit=commit,
                replay=replay, window=win,
                watchdog_default_s=watchdog_default_s,
            )
            # durability barrier: a snapshot exists only once its
            # background write completed
            with _trace.span(
                "stream.pipeline.flush", pending=writer.pending
            ), _telemetry.timed("stream_stage", stage="pipeline_flush"):
                writer.flush()
        except BaseException:
            # make completed snapshot writes durable, then let the
            # original failure win — resume replays from the last
            # COMPLETED snapshot, exactly as the synchronous loop
            with contextlib.suppress(BaseException):
                writer.close()
            raise
        writer.close()
        wall = time.perf_counter() - t0
        return self._result(
            landed["acc"], n_batches, batch, k, start_step, wall,
            counters["snapshots"], degraded[0], resumed_from, run_dir,
            ring_fp, outs_list, collect, pstats=pstats,
        )


def _wrap_i32(v) -> np.ndarray:
    """int64 -> the int32 two's-complement value (the device fold's
    wraparound semantics, applied on host so segment accumulation stays
    bit-identical to one uninterrupted int32 fold)."""
    return (
        (np.asarray(v, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)
    ).astype(np.int64)


def fold_stats_np(out: np.ndarray) -> np.ndarray:
    """(3,) int64 host twin of :func:`fold_stats` (checksum term exact
    mod 2^32; wrap with :func:`_wrap_i32` after accumulating)."""
    o = np.asarray(out, np.int32)
    return np.array(
        [
            int((o ^ (o >> 16)).astype(np.int64).sum()),
            int((o >= 0).sum()),
            int((o == -2).sum()),
        ],
        dtype=np.int64,
    )


def generator_rate(
    gen, key, n_batches: int, batch: int, device=None
) -> tuple[float, float]:
    """(points_per_sec, wall_s) of ``gen`` alone over ``n_batches``
    slots, generated and summed as :func:`ring_from_generator` would
    draw them — the generator cost a sustained number must not fold in.
    The full sum keeps every generated element live; one untimed pass
    warms the generator first."""
    dev = resolve_device(device)

    def gen_loop():
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for g in _slot_generators(key, n_batches, dev):
            acc = acc + gen(g).to(torch.float64).sum()
        return float(acc)  # blocks: the loop's one pull

    with _telemetry.timed(
        "stream_stage", stage="gen_compile", n_batches=n_batches
    ):
        gen_loop()
    t0 = time.perf_counter()
    gen_loop()
    wall = max(time.perf_counter() - t0, 1e-9)
    rate = n_batches * batch / wall
    _telemetry.record(
        "stream_stage", stage="gen_loop", seconds=round(wall, 6),
        n_batches=n_batches, batch=batch, points_per_sec=round(rate, 1),
    )
    return rate, wall
