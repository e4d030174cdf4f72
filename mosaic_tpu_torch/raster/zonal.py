"""Zonal statistics frontends: raster tiles → grid cells / vector zones.

Port of ``mosaic_tpu/raster/zonal.py`` (reference analog: the
`RST_RasterToGrid{Avg,Min,Max,Count}` family):

- :meth:`ZonalEngine.grid` / :func:`zonal_grid` — fold every valid pixel
  into its containing grid cell. Cell assignment runs on the device per
  tile from f64 pixel centers; the host ranks the touched cells, the
  device folds over those ranks, and the host merges the per-tile
  partials keyed by cell id.
- :meth:`ZonalEngine.zones` / :func:`zonal_zones` — fold every valid
  pixel into the vector zone that contains it, through the same probe as
  the point join (`sql/join.py pip_join_points`, adaptive by default, so
  heavy cells go through the ``pip_heavy_tiled`` kernel) with the
  epsilon band on: pixels within the band of a probed chip edge are
  re-joined on the host in f64. The fold is ``zonal_fold`` (f64,
  ``lane="fold"``) or the ``zonal_tiled`` CUDA kernel (f32,
  ``lane="tiled"``).

Fold contract (pinned by the tests): per-tile partials are accumulated in
row-major pixel order, then merged in row-major TILE order with a left
fold. The host oracles (:func:`host_zonal_grid_oracle`,
:func:`host_zonal_zones_oracle`) mirror that decomposition in numpy f64,
so the fold lane is bit-identical to them. The f32 tiled lane holds that
only on exact-summable values (integer-valued pixels whose zone totals
stay under 2**24).

What differs from the reference: tensors are torch on the engine's
device (the card unless ``device="cpu"``); there is no jit, so nothing is
compiled per tile shape; a tile with no pixel to fold skips its device
fold (its partial is empty either way). :meth:`ZonalEngine.map` and
:meth:`ZonalEngine.warmup_expr` run fused expression trees
(`mosaic_tpu_torch/expr`). ``zonal_grid(index_system=None)`` raises
``NotImplementedError`` naming the ROADMAP item that brings it.
``mesh=`` (or the ``MOSAIC_MESH`` knob) shards the zones probe over a
`parallel.mesh.Mesh` with the chip index replicated, as the reference's:
a tile's pixel count must divide over the mesh, and the fold
(``zonal_tiled`` or ``zonal_seq_fold``) runs on the whole tile as
before, so the results are the single-device bits.
``profile=`` resolves ``probe``, ``lookup`` and ``zonal_lane`` at
construction, as the reference's does (one ``tune_resolve`` event,
``zonal_engine``); the port also reads the profile's ``raster_tile`` as
the tile of a :meth:`ZonalEngine.grid`, :meth:`ZonalEngine.zones` or
:meth:`ZonalEngine.map` call that passes none (explicit > env >
profile > the default tile; no event), where the reference's engine
ignores it.

Runtime hooks, as the reference's: every tile of :meth:`ZonalEngine.grid`
and :meth:`ZonalEngine.zones` first passes the ``raster.zonal`` fault
site (`runtime/faults.py`); each call is one ``raster.zonal`` span
(``raster.assign`` child spans per grid tile) and records
``raster_stage`` telemetry (``assign`` and ``zonal`` seconds, pixels/s).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..dispatch import core as _dispatch
from ..kernels.zonal import zonal_fold, zonal_tiled
from ..obs import trace as _trace
from ..parallel import mesh as _mesh
from ..runtime import faults as _faults, telemetry as _telemetry
from ..runtime.errors import CapacityOverflow
from ..tune import resolve as _tune_resolve
from ..sql.join import (
    EDGE_BAND_K,
    OVERFLOW,
    host_join,
    pip_join_points,
    resolve_probe_mode,
)
from .tiles import (
    TilePlan,
    assign_tile_cells,
    plan_tiles,
    stack_tiles,
    tile_centers,
)

__all__ = [
    "ZonalEngine",
    "ZonalResult",
    "host_tile_centers",
    "host_zonal_grid_oracle",
    "host_zonal_zones_oracle",
    "host_zone_partial",
    "resolve_zonal_lane",
    "zonal_grid",
    "zonal_zones",
]


def resolve_zonal_lane(lane: str = "auto") -> str:
    """Resolve the fold lane on the host: ``MOSAIC_RASTER_LANE``
    overrides ``auto``; explicit arguments win over the env. ``fold`` is
    the segment reduce (f64, the bit-identity default), ``tiled`` the f32
    ``zonal_tiled`` kernel."""
    if lane == "auto":
        lane = os.environ.get("MOSAIC_RASTER_LANE", "fold")
    if lane not in ("fold", "tiled"):
        raise ValueError(f"unknown zonal lane {lane!r} (expected fold|tiled)")
    return lane


@dataclasses.dataclass
class ZonalResult:
    """One band's zonal fold. ``keys`` are grid cell ids (grid mode) or
    zone rows 0..G-1 (zone mode); rows with ``count == 0`` are dropped
    before this is built, so every row is backed by real pixels."""

    keys: np.ndarray
    count: np.ndarray
    sum: np.ndarray
    min: np.ndarray
    max: np.ndarray
    band: int
    pixels: int  # valid pixels folded across all keys

    @property
    def mean(self) -> np.ndarray:
        return self.sum / np.maximum(self.count.astype(np.float64), 1.0)

    def stat(self, name: str) -> dict:
        """{key: value} for one statistic (RST_RasterToGrid* shape)."""
        vals = {
            "count": self.count, "sum": self.sum, "min": self.min,
            "max": self.max, "mean": self.mean,
        }[name]
        return {int(k): v.item() for k, v in zip(self.keys, vals)}


class ZonalEngine:
    """Zonal pipelines over one (index_system, resolution) and, for
    zones, one chip index. Runs on the card unless ``device="cpu"``; a
    ``chip_index`` must live on that device."""

    def __init__(
        self,
        index_system,
        resolution: int,
        *,
        chip_index=None,
        found_cap: "int | None" = None,
        heavy_cap: "int | None" = None,
        lookup: "str | None" = None,
        compaction: str = "scatter",
        probe: "str | None" = None,
        convex_cap: "int | None" = None,
        lane: "str | None" = None,
        mesh=None,
        profile=None,
        device=None,
    ):
        # profile-consumed knobs fold at this host entry point: explicit
        # arg > env knob > profile > built-in default (tune/resolve.py).
        # lane="auto" is the legacy spelling of "not passed".
        knobs = _tune_resolve.resolve_knobs(
            "zonal_engine", profile,
            explicit={
                "probe": probe, "lookup": lookup,
                "zonal_lane": None if lane in (None, "auto") else lane,
            },
            defaults={
                "probe": "adaptive", "lookup": "gather", "zonal_lane": "fold",
            },
        )
        probe, lookup = knobs["probe"], knobs["lookup"]
        #: the profile whose raster_tile a call without a tile takes
        self._profile = profile
        dev = resolve_device(device)
        if chip_index is not None:
            if chip_index.device.type != dev.type:
                raise ValueError(
                    f"chip_index lives on {chip_index.device}, the engine "
                    f"runs on {dev}"
                )
            dev = chip_index.device
        self.device = dev
        # placement resolves once, on the host: with a mesh bound, the
        # zones probe runs data parallel over the pixel centers with the
        # chip index replicated (placed once a distinct device)
        self.mesh = _dispatch.resolve_mesh(mesh, device=dev)
        self._placed = (
            None if self.mesh is None or chip_index is None
            else _mesh.replicas(chip_index, self.mesh)
        )
        self.index_system = index_system
        self.resolution = int(resolution)
        self.chip_index = chip_index
        self.lane = resolve_zonal_lane(knobs["zonal_lane"])
        self.num_zones = (
            0 if chip_index is None else int(chip_index.chip_geom.max()) + 1
        )
        self.probe = resolve_probe_mode(probe) if chip_index is not None else probe
        self.acc_dtype = torch.float64
        self._probe_kw = {
            "found_cap": found_cap, "heavy_cap": heavy_cap,
            "convex_cap": convex_cap, "lookup": lookup,
            "compaction": compaction, "probe": self.probe,
        }
        self._host = None
        self._eps2 = None
        if chip_index is not None:
            self._host = getattr(chip_index, "host", None)
            # chip-edge epsilon band: pixel centers within EDGE_BAND_K ulps
            # of a probed chip edge may flip parity between the f32 probe
            # and exact f64 — those are re-joined on the host per tile.
            # Cells are assigned in f64 from f64 centers, so only the
            # parity band can drift.
            # The band is a number rounded once to the table dtype on the
            # host, so the probe's kernel never reads it back from the card.
            if self._host is not None:
                dtype = chip_index.border.verts.dtype
                eps = float(torch.finfo(dtype).eps)
                self._eps2 = torch.tensor(
                    (EDGE_BAND_K * eps * self._host.coord_scale) ** 2,
                    dtype=dtype,
                ).item()

    def _tile(self, tile):
        """The tile shape of one call: explicit > ``MOSAIC_RASTER_TILE`` >
        the profile's ``raster_tile`` > None (`plan_tiles`' default)."""
        return _tune_resolve.resolve_knob(
            "raster_tile", tile, self._profile, None
        )[0]

    # ------------------------------------------------------------ device
    def _assign(self, gt6, origin, th: int, tw: int) -> torch.Tensor:
        """(TH*TW,) int64 cells of one tile's f64 pixel centers."""
        return assign_tile_cells(
            gt6, origin, (th, tw), self.index_system, self.resolution,
            device=self.device,
        )

    def _probe_core(self, pts, cells, ix):
        """(geom, near) of pixel centers against ``ix``."""
        shifted = (pts - ix.border.shift).to(ix.border.verts.dtype)
        out = pip_join_points(shifted, cells, ix, edge_eps2=self._eps2, **self._probe_kw)
        if self._eps2 is None:
            return out, torch.zeros(out.shape, dtype=torch.bool, device=out.device)
        return out

    def _zones_probe(self, gt6, origin, th: int, tw: int):
        """(geom, near) of one tile's pixel centers on the device; under a
        mesh, the probe of each shard of the centers on its device."""
        pts = tile_centers(gt6, origin, th=th, tw=tw, device=self.device)
        cells = self.index_system.point_to_cell(pts, self.resolution).to(torch.int64)
        if self.mesh is None:
            return self._probe_core(pts, cells, self.chip_index)
        return _dispatch.sharded_pointwise(self._probe_core, self.mesh)(
            pts, cells, self._placed
        )

    def _tile_zone_rows(self, plan, t: int, maskb=None) -> np.ndarray:
        """(TH*TW,) zone row per pixel center of tile ``t`` (negative =
        outside every zone): device probe with the epsilon band, exact f64
        host re-join of the banded pixels. ``maskb`` narrows the patch to
        pixels that can contribute; ``None`` patches every banded pixel."""
        th, tw = plan.shape
        if self.mesh is not None and (th * tw) % self.mesh.size:
            raise ValueError(
                f"tile of {th * tw} pixels does not divide over the "
                f"{self.mesh.size}-device mesh — pick a tile shape whose "
                "pixel count is a multiple of the device count"
            )
        gt6 = np.asarray(plan.gt, np.float64)
        geom_d, near_d = self._zones_probe(gt6, plan.origins[t], th, tw)
        geom = geom_d.cpu().numpy()
        if (geom == OVERFLOW).any():
            n = int((geom == OVERFLOW).sum())
            raise CapacityOverflow(
                f"zonal probe overflow on tile {t}: {n} pixels exceeded the "
                "heavy/found/convex caps — leave caps at None for exact sizing",
                stage="raster.zonal", overflow_count=n,
            )
        if self._host is not None:
            near = near_d.cpu().numpy()
            if maskb is not None:
                near = near & maskb
            if near.any():
                pts = host_tile_centers(plan, t)[near]
                geom[near] = host_join(
                    pts, self._host, self.index_system, self.resolution
                )
        return geom

    def _zones_fold(self, vals_flat, seg: np.ndarray):
        """One tile's (g,) partial on the device. A tile with no pixel to
        fold launches nothing: its partial is the empty one."""
        g = self.num_zones
        tiled = self.lane == "tiled"
        dt = torch.float32 if tiled else self.acc_dtype
        if not (seg >= 0).any():
            big = 1e30 if tiled else float("inf")
            return (
                torch.zeros(g, dtype=torch.int32, device=self.device),
                torch.zeros(g, dtype=dt, device=self.device),
                torch.full((g,), big, dtype=dt, device=self.device),
                torch.full((g,), -big, dtype=dt, device=self.device),
            )
        v = torch.from_numpy(np.ascontiguousarray(vals_flat)).to(self.device)
        s = torch.from_numpy(seg).to(self.device)
        if tiled:
            return zonal_tiled(v, s, g)
        return zonal_fold(v, s, g, acc_dtype=dt)

    def _tile_zone_stats_async(self, plan, t: int, vals_flat, mask_flat):
        """One tile's zone partial as DEVICE tensors (not synchronized):
        probe + epsilon host patch, then the device fold over the
        corrected segments."""
        maskb = np.asarray(mask_flat, bool)
        geom = self._tile_zone_rows(plan, t, maskb)
        seg = np.where(maskb & (geom >= 0), geom, -1).astype(np.int32)
        return self._zones_fold(vals_flat, seg)

    def _tile_zone_stats(self, plan, t: int, vals_flat, mask_flat):
        """One tile's zone partial ((g,) count, sum, min, max) as numpy."""
        return tuple(
            a.cpu().numpy()
            for a in self._tile_zone_stats_async(plan, t, vals_flat, mask_flat)
        )

    # ------------------------------------------------------------- grid
    def grid(
        self, raster, band: int = 1,
        tile: "tuple[int, int] | None" = None,
    ) -> ZonalResult:
        """Fold one band into grid cells: per-key (count, sum, min, max)
        merged across tiles in row-major tile order."""
        plan = plan_tiles(raster, self._tile(tile))
        th, tw = plan.shape
        vals, mask = stack_tiles(raster, plan, band, dtype=np.float64)
        gt6 = np.asarray(plan.gt, np.float64)
        merged: dict[int, list] = {}
        t0 = time.perf_counter()
        assign_s = 0.0
        with _trace.span(
            "raster.zonal", mode="grid", ntiles=plan.ntiles, band=band
        ):
            for t in range(plan.ntiles):
                _faults.maybe_fail("raster.zonal")
                ta = time.perf_counter()
                with _trace.span("raster.assign", tile=t):
                    cells = self._assign(
                        gt6, plan.origins[t], th, tw
                    ).cpu().numpy()
                assign_s += time.perf_counter() - ta
                mflat = mask[t].reshape(-1)
                uniq, inv = np.unique(cells[mflat], return_inverse=True)
                if uniq.size == 0:
                    continue
                seg = np.full(th * tw, -1, np.int32)
                seg[mflat] = inv.astype(np.int32)
                # segments are the tile-local dense ranks of the touched cells
                parts = zonal_fold(
                    torch.from_numpy(vals[t].reshape(-1)).to(self.device),
                    torch.from_numpy(seg).to(self.device),
                    uniq.size, acc_dtype=self.acc_dtype,
                )
                cnt, s, mn, mx = (a.cpu().numpy() for a in parts)
                for k, c, sv, mnv, mxv in zip(uniq, cnt, s, mn, mx):
                    row = merged.get(int(k))
                    if row is None:
                        merged[int(k)] = [int(c), sv, mnv, mxv]
                    else:
                        row[0] += int(c)
                        row[1] += sv  # left fold in tile order
                        row[2] = min(row[2], mnv)
                        row[3] = max(row[3], mxv)
        seconds = time.perf_counter() - t0
        _telemetry.record(
            "raster_stage", stage="assign",
            seconds=round(assign_s, 6), ntiles=plan.ntiles,
        )
        _telemetry.record(
            "raster_stage", stage="zonal",
            seconds=round(max(seconds - assign_s, 0.0), 6),
            mode="grid", ntiles=plan.ntiles, cells=len(merged),
            pixels=plan.pixels,
            pixels_per_sec=round(plan.pixels / max(seconds, 1e-9), 1),
        )
        return _result_from_dict(merged, band)

    # ------------------------------------------------------------ zones
    def zones(
        self, raster, band: int = 1,
        tile: "tuple[int, int] | None" = None,
    ) -> ZonalResult:
        """Fold one band into vector zones through the PIP probe. Zone
        keys are geometry rows 0..G-1; pixels outside every zone (or
        nodata, or pad) fold nowhere."""
        if self.chip_index is None:
            raise ValueError(
                "ZonalEngine was built without a chip_index — zones "
                "folds need the vector side"
            )
        fold = self.lane == "fold"
        plan = plan_tiles(raster, self._tile(tile))
        vals, mask = stack_tiles(
            raster, plan, band, dtype=np.float64 if fold else np.float32
        )
        g = self.num_zones
        cnt_acc = np.zeros(g, np.int64)
        sum_acc = np.zeros(g, np.float64 if fold else np.float32)
        min_acc = np.full(g, np.inf)
        max_acc = np.full(g, -np.inf)
        t0 = time.perf_counter()
        with _trace.span(
            "raster.zonal", mode="zones", ntiles=plan.ntiles,
            zones=g, band=band, lane=self.lane,
        ):
            for t in range(plan.ntiles):
                _faults.maybe_fail("raster.zonal")
                cnt, s, mn, mx = self._tile_zone_stats(
                    plan, t, vals[t].reshape(-1), mask[t].reshape(-1)
                )
                cnt = cnt.astype(np.int64)
                live = cnt > 0
                cnt_acc += cnt
                sum_acc = sum_acc + s  # tile-order left fold
                mn = mn.astype(np.float64)
                mx = mx.astype(np.float64)
                min_acc[live] = np.minimum(min_acc[live], mn[live])
                max_acc[live] = np.maximum(max_acc[live], mx[live])
        seconds = time.perf_counter() - t0
        _telemetry.record(
            "raster_stage", stage="zonal",
            seconds=round(seconds, 6), mode="zones",
            ntiles=plan.ntiles, zones=g, lane=self.lane,
            pixels=plan.pixels,
            pixels_per_sec=round(plan.pixels / max(seconds, 1e-9), 1),
        )
        live = cnt_acc > 0
        return ZonalResult(
            keys=np.nonzero(live)[0].astype(np.int64),
            count=cnt_acc[live],
            sum=sum_acc[live].astype(np.float64),
            min=min_acc[live],
            max=max_acc[live],
            band=band,
            pixels=int(cnt_acc.sum()),
        )

    # ------------------------------------------------------ expressions
    def map(
        self, expr, raster, *, tile: "tuple[int, int] | None" = None,
        by: "str | None" = None, watchdog_default_s: float = 600.0,
        retry_policy=None,
    ):
        """Evaluate a fused expression tree (`mosaic_tpu_torch.expr`)
        over ``raster``: one program per tile bucket runs band math,
        masking and the terminal zonal fold. Zonal terminals return a
        :class:`ZonalResult`; ``.join()`` terminals return per-pixel
        (zone, value, valid) planes."""
        from .. import expr as _expr  # local: expr imports this module

        tile = self._tile(tile)
        _value, kind, _by, _stats = _expr.terminal_of(expr)
        if kind == "join":
            return _expr.eval.map_join(self, expr, raster, tile=tile)
        return _expr.map_zonal(
            self, expr, raster, tile=tile, by=by,
            watchdog_default_s=watchdog_default_s,
            retry_policy=retry_policy,
        )

    def warmup_expr(
        self, expr, raster, *, tile: "tuple[int, int] | None" = None,
        by: "str | None" = None,
    ) -> tuple:
        """Run the probe and fused program one :meth:`map` call will
        dispatch once (the probe on every tile, the program on a zero
        tile); returns the registered expression signature for
        `expr.freeze` bookkeeping."""
        from .. import expr as _expr  # local: expr imports this module

        return _expr.warmup_expr(
            self, expr, raster, tile=self._tile(tile), by=by
        )


def _result_from_dict(merged: dict, band: int) -> ZonalResult:
    keys = np.array(sorted(merged), dtype=np.int64)
    rows = [merged[int(k)] for k in keys]
    return ZonalResult(
        keys=keys,
        count=np.array([r[0] for r in rows], dtype=np.int64),
        sum=np.array([r[1] for r in rows], dtype=np.float64),
        min=np.array([r[2] for r in rows], dtype=np.float64),
        max=np.array([r[3] for r in rows], dtype=np.float64),
        band=band,
        pixels=int(sum(r[0] for r in rows)),
    )


def zonal_grid(
    raster, resolution, *, index_system=None, band: int = 1,
    tile: "tuple[int, int] | None" = None, device=None,
) -> ZonalResult:
    """One-shot raster→grid-cell zonal fold (build a :class:`ZonalEngine`
    once and reuse it when folding many rasters)."""
    if index_system is None:
        from ..context import current_context

        index_system = current_context().index_system
    resolution = index_system.resolution_arg(resolution)
    eng = ZonalEngine(index_system, resolution, device=device)
    return eng.grid(raster, band=band, tile=tile)


def zonal_zones(
    raster, chip_index, index_system, resolution, *, band: int = 1,
    tile: "tuple[int, int] | None" = None, probe: str = "adaptive",
    lane: str = "auto", device=None,
) -> ZonalResult:
    """One-shot raster→vector-zone zonal fold via the PIP probe."""
    eng = ZonalEngine(
        index_system, index_system.resolution_arg(resolution),
        chip_index=chip_index, probe=probe, lane=lane, device=device,
    )
    return eng.zones(raster, band=band, tile=tile)


# ---------------------------------------------------------------- oracles


def host_tile_centers(plan: TilePlan, t: int) -> np.ndarray:
    """(TH*TW, 2) f64 pixel centers of tile ``t``, computed on the host
    with the same affine expression (and operation order) as the device
    :func:`~mosaic_tpu_torch.raster.tiles.tile_centers` — f64 on both
    sides, so the coordinates agree bit for bit."""
    th, tw = plan.shape
    r0, c0 = (int(v) for v in plan.origins[t])
    x0, sx, rx, y0, ry, sy = (float(v) for v in plan.gt)
    rr = np.arange(th, dtype=np.float64)[:, None] + float(r0) + 0.5
    cc = np.arange(tw, dtype=np.float64)[None, :] + float(c0) + 0.5
    x = x0 + cc * sx + rr * rx
    y = y0 + cc * ry + rr * sy
    return np.stack(
        [np.broadcast_to(x, (th, tw)).reshape(-1),
         np.broadcast_to(y, (th, tw)).reshape(-1)],
        axis=-1,
    )


def host_zone_partial(pts, vals, maskf, host, index_system, resolution, g: int):
    """One tile's zone fold on the host, f64 and sequential ((g,) i64
    count, (g,) f64 sum, (g,) min, (g,) max) — bit-identical to the
    device fold lane's partial."""
    geom = np.asarray(host_join(pts, host, index_system, resolution))
    seg = np.where(np.asarray(maskf, bool) & (geom >= 0), geom, -1)
    cnt = np.zeros(g, np.int64)
    s = np.zeros(g, np.float64)
    mn = np.full(g, np.inf)
    mx = np.full(g, -np.inf)
    for gg, v in zip(seg, np.asarray(vals, np.float64)):
        if gg >= 0:
            cnt[gg] += 1
            s[gg] += v
            mn[gg] = min(mn[gg], v)
            mx[gg] = max(mx[gg], v)
    return cnt, s, mn, mx


def _host_tile_views(raster, plan: TilePlan, band: int):
    """Yield (t, (P,) f64 values, (P,) bool mask, (P, 2) f64 centers)
    per tile in row-major tile order — the decomposition both oracles
    share with the device path."""
    th, tw = plan.shape
    b = raster.band(band)
    vals_full = b.values.astype(np.float64)
    mask_full = b.mask
    h, w = plan.raster_shape
    for t, (r0, c0) in enumerate(plan.origins):
        vals = np.zeros((th, tw), np.float64)
        mask = np.zeros((th, tw), bool)
        r1 = min(int(r0) + th, h)
        c1 = min(int(c0) + tw, w)
        sub = vals_full[int(r0):r1, int(c0):c1]
        vals[: sub.shape[0], : sub.shape[1]] = sub
        mask[: sub.shape[0], : sub.shape[1]] = mask_full[int(r0):r1, int(c0):c1]
        vals[~mask] = 0
        yield t, vals.reshape(-1), mask.reshape(-1), host_tile_centers(plan, t)


def _oracle_fold(acc: dict, seg, vals):
    """One tile's sequential f64 fold into fresh partials, then a
    left-fold merge into ``acc`` — mirroring the device contract."""
    part: dict = {}
    for g, v in zip(seg.tolist(), vals.tolist()):
        if g < 0:
            continue
        row = part.get(g)
        if row is None:
            part[g] = [1, v, v, v]
        else:
            row[0] += 1
            row[1] += v
            row[2] = min(row[2], v)
            row[3] = max(row[3], v)
    for k, (c, s, mn, mx) in part.items():
        row = acc.get(k)
        if row is None:
            acc[k] = [c, s, mn, mx]
        else:
            row[0] += c
            row[1] += s
            row[2] = min(row[2], mn)
            row[3] = max(row[3], mx)


def host_zonal_grid_oracle(
    raster, resolution, index_system, *, band: int = 1,
    tile: "tuple[int, int] | None" = None,
) -> ZonalResult:
    """Pure-host f64 twin of :meth:`ZonalEngine.grid`: same tile
    decomposition, per-tile sequential accumulation, same tile-order
    merge — the device fold must match this bit for bit."""
    plan = plan_tiles(raster, tile)
    acc: dict = {}
    for _t, vals, mask, pts in _host_tile_views(raster, plan, band):
        cells = np.asarray(index_system.point_to_cell(pts, resolution)).astype(np.int64)
        _oracle_fold(acc, np.where(mask, cells, -1), vals)
    return _result_from_dict(acc, band)


def host_zonal_zones_oracle(
    raster, chip_index, index_system, resolution, *, band: int = 1,
    tile: "tuple[int, int] | None" = None,
) -> ZonalResult:
    """Pure-host f64 twin of :meth:`ZonalEngine.zones`: zone membership
    from the exact f64 host join (`sql/join.py host_join`), fold
    mirroring the tile decomposition."""
    host = getattr(chip_index, "host", None)
    if host is None:
        raise ValueError("chip_index carries no HostRecheck tables")
    plan = plan_tiles(raster, tile)
    acc: dict = {}
    for _t, vals, mask, pts in _host_tile_views(raster, plan, band):
        geom = np.asarray(host_join(pts, host, index_system, resolution))
        _oracle_fold(acc, np.where(mask & (geom >= 0), geom, -1), vals)
    return _result_from_dict(acc, band)
