"""Durable raster scans: the tile twin of `sql/stream.py`.

Port of ``mosaic_tpu/sql/raster_stream.py``. A zonal scan of a large
raster is minutes of device time over thousands of tiles — long enough
that device loss mid-scan is an operational certainty, the regime
`StreamJoin.run_durable` was built for. This module reuses that
machinery for tiles: the scan runs through the pipelined execution core
(`dispatch/pipeline.py`), persisting the fold accumulators (count / sum
/ min / max per zone) and the tile cursor to a checksummed snapshot
(`runtime/checkpoint.py`) every ``snapshot_every`` tiles. Kill the
process anywhere and :meth:`RasterStream.resume` finishes the scan —
converging to a final fold bit-identical to the uninterrupted run,
because the accumulators snapshot exactly and the tile order (row-major
over the tile grid, the `raster/zonal.py` contract) is deterministic.

Resilience per tile matches the point stream: each tile's device work
sits under the ``raster.zonal`` watchdog deadline and the bounded
transient-retry budget. Past the budget a tile on the CPU degrades to
the f64 host twin (`host_zone_partial`, bit-identical to the fold
lane's partial); on the card :class:`RetryExhausted` propagates — no
work moves to the CPU.

Tracing: one ``raster.scan`` span per scan, its context persisted in
every snapshot sidecar so a resume JOINS the killed scan's trace.

What differs from the reference: the stream runs on its index's device;
``lane="fold"`` (the default, the reference's only lane) folds in f64,
``lane="tiled"`` folds with the ``zonal_tiled`` kernel in f32 and
accumulates in f32 as `ZonalEngine.zones` does (so a tiled scan equals a
tiled `zones` call bit for bit); ``scan(expr=...)`` folds a fused
expression tree (`mosaic_tpu_torch/expr`) through the f64 fold lane
whatever the stream's lane, and its snapshots carry the tree's
``expr_sha256`` as the reference's do, so either package resumes the
other's expression scans; ``mesh=`` is the engine's (`ZonalEngine`: the
probe sharded over the mesh, each tile folded whole, the single-device
bits). ``profile=`` takes a `tune.TuningProfile`
as the reference's does: ``probe``/``lookup`` resolve here, the tile
shape and window per scan.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..dispatch import core as _dispatch, pipeline as _pipeline
from ..obs import trace as _trace
from ..runtime import (
    checkpoint as _checkpoint,
    telemetry as _telemetry,
)
from ..runtime.errors import RetryExhausted
from ..tune import resolve as _tune_resolve

__all__ = ["RasterScanResult", "RasterStream"]


def _zonal():
    """`raster/zonal.py`, imported lazily: that module composes on the
    join layer of THIS package, so a module-level import here would be
    a cycle (sql → raster_stream → raster.zonal → sql)."""
    from ..raster import tiles, zonal

    return tiles, zonal


@dataclasses.dataclass
class RasterScanResult:
    """One durable raster scan: the zonal fold + durability metrics
    (``snapshots`` written, ``degraded_tiles`` answered by the host
    twin, ``resumed_from`` tile cursor when this call was a resume)."""

    stats: "ZonalResult"  # noqa: F821 — resolved lazily, see _zonal()
    ntiles: int
    pixels: int
    wall_s: float
    pixels_per_sec: float
    metrics: dict = dataclasses.field(default_factory=dict)


class RasterStream:
    """Durable tiled zonal-statistics scans against one ChipIndex, on the
    index's device. Construction builds nothing on the device; the
    per-tile work is the wrapped :class:`ZonalEngine`'s."""

    def __init__(
        self,
        chip_index,
        index_system,
        resolution: int,
        *,
        found_cap: "int | None" = None,
        heavy_cap: "int | None" = None,
        lookup: "str | None" = None,
        compaction: str = "scatter",
        probe: "str | None" = None,
        convex_cap: "int | None" = None,
        lane: str = "fold",
        mesh=None,
        profile=None,
    ):
        # profile-consumed knobs fold at this host entry point: explicit
        # arg > env knob > profile > built-in default (tune/resolve.py);
        # the tile/window knobs resolve per scan, where they apply
        self._profile = profile
        knobs = _tune_resolve.resolve_knobs(
            "raster_stream", profile,
            explicit={"probe": probe, "lookup": lookup},
            defaults={"probe": "adaptive", "lookup": "gather"},
        )
        probe, lookup = knobs["probe"], knobs["lookup"]
        if lane not in ("fold", "tiled"):
            raise ValueError(f"unknown zonal lane {lane!r} (expected fold|tiled)")
        _tiles, zonal = _zonal()
        self.engine = zonal.ZonalEngine(
            index_system, resolution, chip_index=chip_index,
            found_cap=found_cap, heavy_cap=heavy_cap, lookup=lookup,
            compaction=compaction, probe=probe, convex_cap=convex_cap,
            lane=lane, mesh=mesh, device=chip_index.device,
        )
        self.chip_index = chip_index
        self.index_system = index_system
        self.resolution = int(resolution)
        self.lane = lane

    @property
    def num_zones(self) -> int:
        return self.engine.num_zones

    # -------------------------------------------------------------- API
    def scan(
        self,
        raster,
        *,
        band: int = 1,
        expr=None,
        tile: "tuple[int, int] | None" = None,
        run_dir: "str | None" = None,
        snapshot_every: int = 8,
        watchdog_default_s: float = 600.0,
        retry_policy=None,
        window: "int | None" = None,
    ) -> RasterScanResult:
        """Scan one band — or a fused expression tree over the band
        stack (``expr=``, `mosaic_tpu_torch.expr`) — into per-zone
        (count, sum, min, max). With ``run_dir`` the scan is durable:
        interrupt anywhere and :meth:`resume` finishes it. Durable
        expression scans snapshot the tree's structural hash; resume
        refuses a different tree.

        Tiles ride the pipelined execution core: up to ``window`` tile
        folds are in flight at once (default: the ``MOSAIC_STREAM_WINDOW``
        knob), so tile i's device fold overlaps tile i+1's probe and
        host patch. Accumulation and snapshots happen at the ordered
        drain, so the fold order (and the result, bit for bit) is the
        synchronous loop's."""
        return self._run(
            raster, band=band, expr=expr, tile=tile, run_dir=run_dir,
            snapshot_every=int(snapshot_every), start_tile=0, acc0=None,
            resumed_from=None, watchdog_default_s=watchdog_default_s,
            retry_policy=retry_policy, trace_parent=None, window=window,
        )

    def resume(
        self,
        run_dir: str,
        raster,
        *,
        expr=None,
        watchdog_default_s: float = 600.0,
        retry_policy=None,
        window: "int | None" = None,
    ) -> RasterScanResult:
        """Restart an interrupted durable scan from the newest VALID
        snapshot under ``run_dir``. The snapshot's raster fingerprint,
        tile shape, band, zone count — and for expression scans the
        expression hash — must match: resuming a fold against different
        pixels OR a different tree would silently merge garbage."""
        loaded = _checkpoint.load_latest(run_dir)
        if loaded is None:
            raise FileNotFoundError(
                f"no valid snapshot under {run_dir!r} — nothing to resume"
            )
        step, arrays, meta = loaded
        want_fp = meta.get("raster_sha256")
        if want_fp and want_fp != _checkpoint.fingerprint(
            np.ascontiguousarray(raster.data)
        ):
            raise ValueError(
                "snapshot raster fingerprint mismatch — this is not "
                "the raster the interrupted scan was folding"
            )
        if int(meta.get("num_zones", self.num_zones)) != self.num_zones:
            raise ValueError(
                f"snapshot zone count {meta.get('num_zones')} != this "
                f"stream's {self.num_zones}"
            )
        want_expr = meta.get("expr_sha256")
        have_expr = None
        if expr is not None:
            from .. import expr as _expr  # lazy: see _zonal()

            have_expr = _expr.tree_hash(expr)
        if want_expr != have_expr:
            raise ValueError(
                "snapshot expression mismatch — the interrupted scan "
                f"folded tree {want_expr!r}, resume was given "
                f"{have_expr!r}; pass the same expression (structural "
                "equality) or none at all"
            )
        # a snapshot without the key is the reference's, whose only lane
        # is the fold; the lanes' partial sums differ in type and order
        # (an expression scan always folds in the f64 fold lane)
        snap_lane = meta.get("lane", "fold")
        lane = "fold" if expr is not None else self.lane
        if snap_lane != lane:
            raise ValueError(
                f"snapshot lane {snap_lane!r} != this scan's {lane!r} "
                "— the partial sums of one lane do not continue the other's"
            )
        tile = tuple(meta["tile"]) if meta.get("tile") else None
        return self._run(
            raster, band=int(meta.get("band", 1)), expr=expr, tile=tile,
            run_dir=run_dir,
            snapshot_every=int(meta.get("snapshot_every", 8)),
            start_tile=int(step),
            acc0={k: np.asarray(v) for k, v in arrays.items()},
            resumed_from=int(step),
            watchdog_default_s=watchdog_default_s,
            retry_policy=retry_policy,
            trace_parent=_trace.SpanContext.from_dict(meta.get("trace")),
            window=window,
        )

    # ------------------------------------------------------------ engine
    def _run(
        self, raster, *, band, expr, tile, run_dir, snapshot_every,
        start_tile, acc0, resumed_from, watchdog_default_s,
        retry_policy, trace_parent, window=None,
    ) -> RasterScanResult:
        tiles, _zn = _zonal()
        # per-scan knobs: an explicit tile (or a resume's snapshot tile)
        # wins, then MOSAIC_RASTER_TILE / MOSAIC_STREAM_WINDOW, then the
        # constructor's TuningProfile, then the built-in defaults
        knobs = _tune_resolve.resolve_knobs(
            "raster_stream.scan", self._profile,
            explicit={"raster_tile": tile, "stream_window": window},
            defaults={"raster_tile": None, "stream_window": None},
        )
        tile, window = knobs["raster_tile"], knobs["stream_window"]
        plan = tiles.plan_tiles(raster, tile)
        th, tw = plan.shape
        root = _trace.start_span(
            "raster.scan",
            parent=trace_parent,
            ntiles=plan.ntiles, th=th, tw=tw, band=band,
            zones=self.num_zones, resumed_from=resumed_from,
            fused=expr is not None,
        )
        try:
            return self._run_traced(
                raster, plan=plan, band=band, expr=expr, run_dir=run_dir,
                snapshot_every=max(1, int(snapshot_every)),
                start_tile=start_tile, acc0=acc0,
                resumed_from=resumed_from,
                watchdog_default_s=watchdog_default_s,
                retry_policy=retry_policy, root=root, window=window,
            )
        except BaseException as e:  # noqa: BLE001 — stamped, re-raised
            root.set(error=type(e).__name__)
            raise
        finally:
            root.end()

    def _run_traced(
        self, raster, *, plan, band, expr, run_dir, snapshot_every,
        start_tile, acc0, resumed_from, watchdog_default_s,
        retry_policy, root, window=None,
    ) -> RasterScanResult:
        tiles, zonal = _zonal()
        th, tw = plan.shape
        g = self.num_zones
        eng = self.engine
        fold = self.lane == "fold" or expr is not None
        acc_np = np.float64 if fold else np.float32
        expr_sha = None
        if expr is None:
            vals, mask = tiles.stack_tiles(raster, plan, band, dtype=acc_np)
        else:
            # fused expression scan: stage the whole referenced band
            # stack; per tile ONE program computes the tree and folds it
            from .. import expr as _expr  # lazy: see _zonal()
            from ..expr import compile as _ec, eval as _ee

            value, kind, by, _stats = _expr.terminal_of(expr)
            if kind != "zonal" or (by or "zones") != "zones":
                raise ValueError(
                    "RasterStream.scan(expr=...) folds zones — use a "
                    "zones zonal terminal (or a bare value tree)"
                )
            _expr.validate(expr, raster.num_bands, has_zones=True, by="zones")
            expr_sha = _expr.tree_hash(expr)
            vals, mask = _ee.stack_bands(raster, plan, _expr.bands_of(value))
            acc_name = _ee.acc_name(eng)
            expr_prog = _ec.zonal_program(
                value, th, tw, g, acc_name, eng.index_system, eng.resolution,
            )
            expr_sig = _ec.signature_of(
                value, th, tw, g, acc_name, eng.index_system,
                eng.resolution, eng.mesh,
            )
            band = 0  # snapshot meta: fused scans read the stack
        if acc0 is None:
            cnt_acc = np.zeros(g, np.int64)
            sum_acc = np.zeros(g, acc_np)
            min_acc = np.full(g, np.inf)
            max_acc = np.full(g, -np.inf)
        else:
            cnt_acc = np.asarray(acc0["count"], np.int64).copy()
            sum_acc = np.asarray(acc0["sum"], acc_np).copy()
            min_acc = np.asarray(acc0["min"], np.float64).copy()
            max_acc = np.asarray(acc0["max"], np.float64).copy()
        meta = None
        if run_dir is not None:
            meta = {
                "ntiles": plan.ntiles,
                "tile": [th, tw],
                "band": int(band),
                "num_zones": g,
                "snapshot_every": int(snapshot_every),
                "raster_sha256": _checkpoint.fingerprint(
                    np.ascontiguousarray(raster.data)
                ),
                "expr_sha256": expr_sha,
                "lane": "fold" if fold else self.lane,
                "trace": root.context.as_dict(),
            }
        host = getattr(self.chip_index, "host", None)
        degrades = host is not None and eng.device.type == "cpu"
        degraded = [0]
        counters = {"snapshots": 0}
        start = int(start_tile)
        win = _pipeline.resolve_window(window)

        # launch runs tile t's probe, host patch and fold WITHOUT the
        # blocking pull of its partials; the ordered drain pulls them
        # under the watchdog and the caller-thread commit accumulates
        # them, so the fold order — and the float result, bit for bit —
        # is the synchronous loop's. Fault plans trip inside the launch
        # guard: transient errors retry/degrade, others abort.
        def launch(i):
            t = start + i

            if expr is None:
                def dispatch(t=t):
                    return eng._tile_zone_stats_async(
                        plan, t, vals[t].reshape(-1), mask[t].reshape(-1),
                    )
            else:
                def dispatch(t=t):
                    # probe + epsilon patch, then the fused
                    # expression+fold program
                    geom = eng._tile_zone_rows(plan, t)
                    seg = np.where(geom >= 0, geom, -1).astype(np.int32)
                    return _ec.run_zonal_async(
                        expr_prog, expr_sig,
                        np.asarray(plan.gt, np.float64), plan.origins[t],
                        vals[t], mask[t], seg, device=eng.device,
                    )

            with _trace.span("raster.zonal", step=t, n=1, pipelined=True):
                try:
                    return ("dev", _dispatch.guarded_call(
                        "raster.zonal", dispatch,
                        default_s=watchdog_default_s,
                        policy=retry_policy,
                    ))
                except RetryExhausted as e:
                    if not degrades:
                        raise
                    _telemetry.record(
                        "degraded", label="raster.zonal", step=t,
                        attempts=e.attempts, error=repr(e.last)[:200],
                    )
                    if expr is not None:
                        return ("host", _expr.host_expr_tile_partial(
                            value, vals[t], mask[t],
                            zonal.host_tile_centers(plan, t),
                            index_system=self.index_system,
                            resolution=self.resolution,
                            host=host, num_segments=g, by="zones",
                        ))
                    return ("host", zonal.host_zone_partial(
                        zonal.host_tile_centers(plan, t),
                        vals[t].reshape(-1), mask[t].reshape(-1),
                        host, self.index_system, self.resolution, g,
                    ))

        def land(i, handle):
            # runs under the drain watchdog, whose deadline ABANDONS the
            # worker thread — pull ALL four partials here and mutate
            # nothing
            kind, parts = handle
            cnt, s, mn, mx = (
                p.cpu().numpy() if kind == "dev" else np.asarray(p)
                for p in parts
            )
            return (
                kind, cnt.astype(np.int64), s,
                mn.astype(np.float64), mx.astype(np.float64),
            )

        def commit(i, pulled):
            nonlocal cnt_acc, sum_acc
            kind, cnt, s, mn, mx = pulled
            if kind == "host":
                # degradation counts at materialization, not launch
                degraded[0] += 1
            live = cnt > 0
            cnt_acc += cnt
            sum_acc = sum_acc + s.astype(acc_np)  # tile-order left fold
            min_acc[live] = np.minimum(min_acc[live], mn[live])
            max_acc[live] = np.maximum(max_acc[live], mx[live])
            se = start + i + 1
            # the snapshot write runs here on the caller thread and
            # swallows its own failures, so nothing after the fold can
            # raise a transient that would replay (and double-count) it
            if run_dir is not None and (
                (se - start) % snapshot_every == 0 or se == plan.ntiles
            ):
                payload = {
                    "count": cnt_acc, "sum": sum_acc,
                    "min": min_acc, "max": max_acc,
                }
                with _trace.span("raster.snapshot", step=se):
                    try:
                        _checkpoint.save_snapshot(run_dir, se, payload, meta)
                        counters["snapshots"] += 1
                    except Exception as e:  # lint: broad-except-ok (durability degrades — coarser resume point — but a sick disk must not kill the scan)
                        _telemetry.record(
                            "snapshot_skipped", run_dir=run_dir,
                            step=se, error=repr(e)[:200],
                        )

        def replay(lo, hi):
            # tiles carry no cross-tile device state, so the synchronous
            # path IS launch + pull + commit
            for j in range(lo, hi + 1):
                commit(j, land(j, launch(j)))

        t0 = time.perf_counter()
        pstats = _pipeline.execute_pipeline(
            plan.ntiles - start, launch, land,
            drain_site="raster.pipeline.drain", commit=commit,
            replay=replay, window=win,
            watchdog_default_s=watchdog_default_s,
        )
        degraded_tiles = degraded[0]
        snapshots = counters["snapshots"]
        wall = time.perf_counter() - t0
        n_run = plan.ntiles - start
        px_run = n_run * th * tw
        _telemetry.record(
            "raster_stage", stage="scan",
            seconds=round(wall, 6), ntiles=plan.ntiles,
            th=th, tw=tw, zones=g, snapshots=snapshots,
            degraded_tiles=degraded_tiles, resumed_from=resumed_from,
            window=pstats.window, lane=self.lane,
            pixels_per_sec=round(px_run / max(wall, 1e-9), 1),
        )
        live = cnt_acc > 0
        stats = zonal.ZonalResult(
            keys=np.nonzero(live)[0].astype(np.int64),
            count=cnt_acc[live],
            sum=sum_acc[live].astype(np.float64),
            min=min_acc[live],
            max=max_acc[live],
            band=band,
            pixels=int(cnt_acc.sum()),
        )
        return RasterScanResult(
            stats=stats,
            ntiles=plan.ntiles,
            pixels=plan.pixels,
            wall_s=wall,
            pixels_per_sec=px_run / max(wall, 1e-9),
            metrics={
                "degraded": degraded_tiles > 0,
                "degraded_tiles": degraded_tiles,
                "snapshots": snapshots,
                "resumed_from": resumed_from,
                "run_dir": run_dir,
                "pipeline": pstats.as_dict(),
            },
        )
