"""Execute compiled expression trees through the dispatch core's
guarded path.

Port of ``mosaic_tpu/expr/eval.py``. `map_zonal` is the fused twin of
`ZonalEngine.zones`/`grid`: per tile the zone segments come from the SAME
probe machinery (the PIP probe through ``pip_heavy_tiled`` on the card,
plus the epsilon-band exact host re-join — pixels exactly on zone edges
are patched before the fold), then ONE fused program reads the raw band
stack and emits per-segment stats. Each tile dispatch runs under
``guarded_call("expr.map", ...)`` so watchdog and transient retry come
for free; past the retry budget a tile on the CPU degrades to the f64
host twin (`expr.host_oracle.host_expr_tile_partial`, bit-identical by
construction), while on the card :class:`RetryExhausted` propagates — no
work moves to the CPU (the port's rule since the exact join).

The fold lane is always the f64 segment fold regardless of the engine's
``lane`` — the expression layer's contract is bit-identity with the
numpy-f64 interpreter, which the f32 tiled lane cannot hold on arbitrary
band math.
"""

from __future__ import annotations

import time

import numpy as np

from ..dispatch import core as _dispatch
from ..obs import trace as _trace
from ..raster.tiles import plan_tiles, stack_tiles
from ..raster.zonal import ZonalResult, _result_from_dict, host_tile_centers
from ..runtime import telemetry as _telemetry
from ..runtime.errors import RetryExhausted
from . import ast, compile as _compile

__all__ = [
    "acc_name", "map_join", "map_pixels", "map_zonal", "stack_bands",
    "warmup_expr",
]


def stack_bands(raster, plan, bands):
    """((T, B, P) f64 values, (T, B, P) bool mask) — per-band
    `stack_tiles` (pad ∧ not-nodata ∧ not-NaN mask, zeros at invalid)
    stacked in sorted band order (``ast.bands_of``), the layout every
    expression program consumes."""
    th, tw = plan.shape
    p = th * tw
    vals = np.zeros((plan.ntiles, len(bands), p), np.float64)
    mask = np.zeros((plan.ntiles, len(bands), p), bool)
    for r, b in enumerate(bands):
        v, m = stack_tiles(raster, plan, b, dtype=np.float64)
        vals[:, r, :] = v.reshape(plan.ntiles, p)
        mask[:, r, :] = m.reshape(plan.ntiles, p)
    return vals, mask


def acc_name(engine) -> str:
    """The name of ``engine``'s fold dtype, as program signatures key it."""
    return str(engine.acc_dtype).removeprefix("torch.")


def map_zonal(
    engine, expr: ast.Expr, raster, *,
    tile=None, by: "str | None" = None,
    watchdog_default_s: float = 600.0, retry_policy=None,
) -> ZonalResult:
    """Fold an expression into vector zones or grid cells: one fused
    program per tile bucket, per-zone results bit-identical to the
    staged pipeline (`map_pixels` then `ZonalEngine.zones`) AND the f64
    host oracle."""
    value, kind, term_by, _stats = ast.terminal_of(expr)
    if kind != "zonal":
        raise ValueError(
            "map_zonal needs a zonal terminal (or a bare value tree) — "
            "use map_join for join terminals"
        )
    by = by or term_by
    has_zones = engine.chip_index is not None
    if by == "zones" and not has_zones:
        raise ValueError(
            "ZonalEngine was built without a chip_index — zones folds "
            "need the vector side"
        )
    ast.validate(expr, raster.num_bands, has_zones=has_zones, by=by)
    plan = plan_tiles(raster, tile)
    th, tw = plan.shape
    gt6 = np.asarray(plan.gt, np.float64)
    bands = ast.bands_of(value)
    vals, mask = stack_bands(raster, plan, bands)
    acc = acc_name(engine)
    num_segments = engine.num_zones if by == "zones" else th * tw
    prog = _compile.zonal_program(
        value, th, tw, num_segments, acc,
        engine.index_system, engine.resolution,
    )
    sig = _compile.signature_of(
        value, th, tw, num_segments, acc,
        engine.index_system, engine.resolution, engine.mesh,
    )
    dev = engine.device
    degrades = dev.type == "cpu"

    g = engine.num_zones
    cnt_acc = np.zeros(g, np.int64)
    sum_acc = np.zeros(g, np.float64)
    min_acc = np.full(g, np.inf)
    max_acc = np.full(g, -np.inf)
    merged: dict = {}
    degraded = 0
    t0 = time.perf_counter()
    with _trace.span(
        "expr.map", mode=by, ntiles=plan.ntiles, bands=len(bands),
        segments=num_segments,
    ):
        for t in range(plan.ntiles):
            uniq = None
            if by == "zones":
                geom = engine._tile_zone_rows(plan, t)
                seg = np.where(geom >= 0, geom, -1).astype(np.int32)
            else:
                cells = engine._assign(
                    gt6, plan.origins[t], th, tw
                ).cpu().numpy()
                uniq, inv = np.unique(cells, return_inverse=True)
                seg = inv.astype(np.int32)

            def dispatch(ti=t, seg_t=seg):
                return _compile.run_zonal(
                    prog, sig, gt6, plan.origins[ti],
                    vals[ti], mask[ti], seg_t, device=dev,
                )

            try:
                cnt, s, mn, mx = _dispatch.guarded_call(
                    "expr.map", dispatch,
                    default_s=watchdog_default_s, policy=retry_policy,
                )
            except RetryExhausted as e:
                if not degrades:
                    raise
                _telemetry.record(
                    "degraded", label="expr.map", tile=t,
                    error=type(e).__name__,
                )
                degraded += 1
                pts = host_tile_centers(plan, t)
                part = _compile_host_partial(
                    value, vals[t], mask[t], pts, engine, by,
                    num_segments,
                )
                if by == "zones":
                    cnt, s, mn, mx = part
                else:
                    for k, row in part.items():
                        _merge_row(merged, int(k), row)
                    continue
            if by == "zones":
                cnt = np.asarray(cnt).astype(np.int64)
                live = cnt > 0
                cnt_acc += cnt
                sum_acc = sum_acc + np.asarray(s)  # tile-order left fold
                mn = np.asarray(mn, np.float64)
                mx = np.asarray(mx, np.float64)
                min_acc[live] = np.minimum(min_acc[live], mn[live])
                max_acc[live] = np.maximum(max_acc[live], mx[live])
            else:
                cnt = np.asarray(cnt)[: uniq.size]
                s = np.asarray(s)[: uniq.size]
                mn = np.asarray(mn)[: uniq.size]
                mx = np.asarray(mx)[: uniq.size]
                for k, c, sv, mnv, mxv in zip(uniq, cnt, s, mn, mx):
                    if int(c) == 0:
                        continue  # only invalid pixels touched the cell
                    _merge_row(merged, int(k), [int(c), sv, mnv, mxv])
    seconds = time.perf_counter() - t0
    _telemetry.record(
        "expr_stage", stage="map", seconds=round(seconds, 6),
        mode=by, ntiles=plan.ntiles, bands=len(bands),
        segments=num_segments, pixels=plan.pixels,
        pixels_per_sec=round(plan.pixels / max(seconds, 1e-9), 1),
        degraded=degraded,
    )
    if by == "grid":
        return _result_from_dict(merged, band=0)
    live = cnt_acc > 0
    return ZonalResult(
        keys=np.nonzero(live)[0].astype(np.int64),
        count=cnt_acc[live],
        sum=sum_acc[live].astype(np.float64),
        min=min_acc[live],
        max=max_acc[live],
        band=0,
        pixels=int(cnt_acc.sum()),
    )


def _merge_row(merged: dict, k: int, row):
    have = merged.get(k)
    if have is None:
        merged[k] = [int(row[0]), row[1], row[2], row[3]]
    else:
        have[0] += int(row[0])
        have[1] += row[1]  # left fold in tile order
        have[2] = min(have[2], row[2])
        have[3] = max(have[3], row[3])


def _compile_host_partial(value, vals_t, mask_t, pts, engine, by,
                          num_segments):
    from .host_oracle import host_expr_tile_partial

    return host_expr_tile_partial(
        value, vals_t, mask_t, pts,
        index_system=engine.index_system,
        resolution=engine.resolution,
        host=getattr(engine, "_host", None),
        num_segments=num_segments, by=by,
    )


def map_pixels(
    expr: ast.Expr, raster, *, tile=None,
    index_system=None, resolution=None, seg_of=None, device=None,
) -> "tuple[np.ndarray, np.ndarray]":
    """Evaluate a bare value tree per pixel: ((H, W) f64 values,
    (H, W) bool valid) stitched from one fused per-pixel program per
    tile bucket, on ``device`` (the card unless ``device="cpu"``). Zone
    nodes need ``seg_of`` (tile → (P,) zone rows); `CellOf` needs
    (index_system, resolution)."""
    from .. import resolve_device

    if isinstance(expr, ast.Zonal):
        raise ValueError(
            "map_pixels evaluates value trees — the zonal terminal "
            "belongs to ZonalEngine.map"
        )
    value, _kind, _by, _stats = ast.terminal_of(expr)
    if ast.uses_cells(value) and (index_system is None or resolution is None):
        raise ValueError(
            "cell_of() needs index_system and resolution (session "
            "context for rst_mapbands)"
        )
    ast.validate(
        value, raster.num_bands, has_zones=seg_of is not None,
    )
    dev = resolve_device(device)
    plan = plan_tiles(raster, tile)
    th, tw = plan.shape
    p = th * tw
    gt6 = np.asarray(plan.gt, np.float64)
    bands = ast.bands_of(value)
    vals, mask = stack_bands(raster, plan, bands)
    res = -1 if resolution is None else int(resolution)
    prog = _compile.pixel_program(value, th, tw, index_system, res)
    sig = _compile.signature_of(
        value, th, tw, 0, "float64", index_system, res,
    )
    h, w = plan.raster_shape
    out = np.full((h, w), np.nan, np.float64)
    valid = np.zeros((h, w), bool)
    seg0 = np.full(p, -1, np.int32)
    t0 = time.perf_counter()
    with _trace.span("expr.map", mode="pixels", ntiles=plan.ntiles,
                     bands=len(bands)):
        for t in range(plan.ntiles):
            seg = seg0 if seg_of is None else np.asarray(
                seg_of(t), np.int32
            )
            v, m = _compile.run_pixels(
                prog, sig, gt6, plan.origins[t], vals[t], mask[t], seg,
                device=dev,
            )
            r0, c0 = (int(x) for x in plan.origins[t])
            r1 = min(r0 + th, h)
            c1 = min(c0 + tw, w)
            out[r0:r1, c0:c1] = v.reshape(th, tw)[: r1 - r0, : c1 - c0]
            valid[r0:r1, c0:c1] = m.reshape(th, tw)[
                : r1 - r0, : c1 - c0
            ]
    seconds = time.perf_counter() - t0
    _telemetry.record(
        "expr_stage", stage="pixels", seconds=round(seconds, 6),
        ntiles=plan.ntiles, bands=len(bands), pixels=plan.pixels,
        pixels_per_sec=round(plan.pixels / max(seconds, 1e-9), 1),
    )
    out[~valid] = np.nan
    return out, valid


def map_join(
    engine, expr: ast.Expr, raster, *, tile=None,
) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """Join terminal: ((H, W) int32 zone row or -1, (H, W) f64 value,
    (H, W) bool valid) — the raster side of a raster×vector join,
    zone membership epsilon-band exact."""
    value, kind, _by, _stats = ast.terminal_of(expr)
    if kind != "join":
        raise ValueError("map_join needs a .join() terminal")
    if engine.chip_index is None:
        raise ValueError("map_join needs the vector side (chip_index)")
    ast.validate(value, raster.num_bands, has_zones=True, by="zones")
    plan = plan_tiles(raster, tile)
    th, tw = plan.shape
    h, w = plan.raster_shape
    zones = np.full((h, w), -1, np.int32)
    segs: dict = {}

    def seg_of(t):
        geom = engine._tile_zone_rows(plan, t)
        s = np.where(geom >= 0, geom, -1).astype(np.int32)
        segs[t] = s
        return s

    vals, valid = map_pixels(
        value, raster, tile=tile,
        index_system=engine.index_system, resolution=engine.resolution,
        seg_of=seg_of, device=engine.device,
    )
    for t in range(plan.ntiles):
        r0, c0 = (int(x) for x in plan.origins[t])
        r1 = min(r0 + th, h)
        c1 = min(c0 + tw, w)
        zones[r0:r1, c0:c1] = segs[t].reshape(th, tw)[
            : r1 - r0, : c1 - c0
        ]
    zones[~valid] = -1
    return zones, vals, valid


def warmup_expr(
    engine, expr: ast.Expr, raster, *, tile=None,
    by: "str | None" = None,
) -> tuple:
    """Run once everything one `map_zonal` call will dispatch — the
    fused expression program (on a zero tile) and, for zones mode, the
    FULL per-tile membership path: probe plus epsilon-band host patch
    for every tile of the plan (this binds the kernel library and primes
    the allocator at every tile's shapes). Returns the registered
    signature; after ``expr.freeze()``, a novel tree or bucket trips the
    cold-compile counter."""
    value, _kind, term_by, _stats = ast.terminal_of(expr)
    by = by or term_by
    plan = plan_tiles(raster, tile)
    th, tw = plan.shape
    gt6 = np.asarray(plan.gt, np.float64)
    num_segments = engine.num_zones if by == "zones" else th * tw
    if by == "zones":
        for t in range(plan.ntiles):
            engine._tile_zone_rows(plan, t)
    else:
        engine._assign(gt6, plan.origins[0], th, tw).cpu()
    return _compile.warmup_zonal(
        value, th, tw, num_segments, acc_name(engine),
        engine.index_system, engine.resolution, engine.mesh,
        device=engine.device,
    )
