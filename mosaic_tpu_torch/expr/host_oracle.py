"""numpy-f64 interpreter of expression trees — the bit-identity bar.

Port of ``mosaic_tpu/expr/host_oracle.py`` (plain numpy, copied; it
reads the port's `raster/zonal.py` host helpers, `sql/join.py
host_join` and `sql/overlay.py`). Every fused result is required to
match this interpreter bit for bit: :func:`interpret` walks the SAME
tree with the SAME operation order and the SAME mask-propagation rule
as the lowering in `expr/compile.py`, in plain numpy f64 — elementwise
IEEE ops agree bit-exactly between torch and numpy, and the affine
center/cell/membership machinery reuses the per-layer oracles
(`raster.zonal.host_tile_centers`, the index system's numpy
``point_to_cell``, `sql.join.host_join`) the zonal tests already pin
against the device.

Consumers:

- :func:`host_expr_zonal_oracle` — the full unfused twin of
  `expr.eval.map_zonal` (same tile decomposition, per-tile sequential
  f64 fold, row-major left-fold merge).
- :func:`host_expr_tile_partial` — ONE tile's partial, the degradation
  twin `eval` substitutes when a tile's dispatch on the CPU exhausts its
  retry budget; being bit-identical, a degraded tile does not perturb
  the fold.
- :func:`host_overlay_measures` — the numpy twin of the overlay
  measure lane (`sql/overlay.py`), and its f64 override splice.
"""

from __future__ import annotations

import numpy as np

from ..raster.tiles import plan_tiles
from ..raster.zonal import (
    ZonalResult,
    _oracle_fold,
    _result_from_dict,
    host_tile_centers,
)
from ..sql.join import host_join
from . import ast

__all__ = [
    "host_expr_tile_partial",
    "host_expr_zonal_oracle",
    "host_fold_partial",
    "host_overlay_measures",
    "host_pair_override",
    "interpret",
    "interpret_pair",
    "splice_override",
]

_BIN = {
    "add": np.add,
    "sub": np.subtract,
    "mul": np.multiply,
    "div": np.divide,
    "min": np.minimum,
    "max": np.maximum,
}
_CMP = {
    "lt": np.less,
    "le": np.less_equal,
    "gt": np.greater,
    "ge": np.greater_equal,
    "eq": np.equal,
    "ne": np.not_equal,
}


class HostCtx:
    """Interpretation context for one tile: ``vals``/``mask`` are the
    (B, P) f64/bool stack rows (row order = sorted band indices, same
    layout the device programs consume), ``cells`` the (P,) i64 cell
    ids, ``seg`` the (P,) zone row per pixel (-1 outside every zone)."""

    def __init__(self, vals, mask, rows, cells=None, seg=None):
        self.vals = vals
        self.mask = mask
        self.rows = rows
        self.cells = cells
        self.seg = seg


def interpret(node: ast.Expr, ctx: HostCtx):
    """→ (value, valid) numpy arrays — the f64 mirror of the device
    lowering, op for op (div by zero runs under errstate-ignore so the
    oracle reaches the same inf/NaN bits the device produces)."""
    true = np.True_
    if isinstance(node, ast.Band):
        r = ctx.rows[node.index]
        return ctx.vals[r], ctx.mask[r]
    if isinstance(node, ast.Const):
        return np.float64(node.value), true
    if isinstance(node, (ast.BinOp, ast.Compare)):
        av, am = interpret(node.a, ctx)
        bv, bm = interpret(node.b, ctx)
        fn = _BIN[node.op] if isinstance(node, ast.BinOp) else _CMP[node.op]
        with np.errstate(divide="ignore", invalid="ignore"):
            return fn(av, bv), am & bm
    if isinstance(node, ast.BoolOp):
        av, am = interpret(node.a, ctx)
        bv, bm = interpret(node.b, ctx)
        return (av & bv) if node.op == "and" else (av | bv), am & bm
    if isinstance(node, ast.Not):
        av, am = interpret(node.a, ctx)
        return ~av, am
    if isinstance(node, ast.Where):
        cv, cm = interpret(node.cond, ctx)
        av, am = interpret(node.a, ctx)
        bv, bm = interpret(node.b, ctx)
        return np.where(cv, av, bv), cm & np.where(cv, am, bm)
    if isinstance(node, ast.MaskWhere):
        vv, vm = interpret(node.value, ctx)
        cv, cm = interpret(node.cond, ctx)
        return vv, vm & cm & cv
    if isinstance(node, ast.CellOf):
        return ctx.cells, true
    if isinstance(node, ast.InZone):
        return ctx.seg >= 0, true
    if isinstance(node, ast.ZoneData):
        table = np.asarray(node.values, np.float64)
        inside = ctx.seg >= 0
        idx = np.where(inside, ctx.seg, 0)
        return np.where(
            inside, table[idx], np.float64(node.fill)
        ), true
    raise TypeError(
        f"cannot interpret {type(node).__name__} — peel the terminal "
        "first"
    )


def _stack_band_views(raster, plan, bands):
    """Per-tile generator of the multi-band twin of
    `raster.zonal._host_tile_views`: yields (t, (B, P) f64 values,
    (B, P) bool mask, (P, 2) f64 centers) in row-major tile order."""
    th, tw = plan.shape
    h, w = plan.raster_shape
    full = [
        (raster.band(b).values.astype(np.float64), raster.band(b).mask)
        for b in bands
    ]
    for t, (r0, c0) in enumerate(plan.origins):
        vals = np.zeros((len(bands), th, tw), np.float64)
        mask = np.zeros((len(bands), th, tw), bool)
        r1 = min(int(r0) + th, h)
        c1 = min(int(c0) + tw, w)
        for i, (vf, mf) in enumerate(full):
            sub = vf[int(r0):r1, int(c0):c1]
            vals[i, : sub.shape[0], : sub.shape[1]] = sub
            mask[i, : sub.shape[0], : sub.shape[1]] = mf[
                int(r0):r1, int(c0):c1
            ]
        vals[~mask] = 0
        yield (
            t,
            vals.reshape(len(bands), -1),
            mask.reshape(len(bands), -1),
            host_tile_centers(plan, t),
        )


def host_fold_partial(vals, valid, seg, num_segments: int):
    """One tile's sequential f64 fold into dense (S,) partials — the
    host twin of the fused program's masked segment fold, row-major
    pixel order (the order the fold lane applies updates in)."""
    g = int(num_segments)
    cnt = np.zeros(g, np.int64)
    s = np.zeros(g, np.float64)
    mn = np.full(g, np.inf)
    mx = np.full(g, -np.inf)
    seg = np.asarray(seg)
    valid = np.asarray(valid, bool)
    for gg, ok, v in zip(seg, valid, np.asarray(vals, np.float64)):
        if ok and gg >= 0:
            cnt[gg] += 1
            s[gg] += v
            mn[gg] = min(mn[gg], v)
            mx[gg] = max(mx[gg], v)
    return cnt, s, mn, mx


def _tile_ctx(raster_ctx, value, pts, index_system, resolution, host):
    """Fill the cells/seg members a tree actually uses — membership via
    the exact f64 host join, cells via the host-side point_to_cell."""
    cells = None
    seg = None
    if ast.uses_cells(value):
        cells = np.asarray(
            index_system.point_to_cell(pts, resolution)
        ).astype(np.int64)
    if host is not None:
        seg = np.asarray(
            host_join(pts, host, index_system, resolution)
        )
    raster_ctx.cells = cells
    raster_ctx.seg = seg
    return raster_ctx


def host_expr_tile_partial(
    value: ast.Expr, vals, mask, pts, *,
    index_system, resolution, host, num_segments: int, by: str,
):
    """ONE tile's zone/grid partial on the host — the degradation twin
    of the fused device tile dispatch. ``vals``/``mask`` are the (B, P)
    stack; returns dense (S,) (count, sum, min, max) for ``by="zones"``
    (S = num_zones) or a {cell_id: [c, s, mn, mx]} dict for grid."""
    rows = _band_rows(value)
    ctx = HostCtx(np.asarray(vals, np.float64), np.asarray(mask, bool),
                  rows)
    _tile_ctx(ctx, value, pts, index_system, resolution, host)
    v, m = interpret(value, ctx)
    p = ctx.mask.shape[-1] if ctx.mask.size else len(pts)
    v = np.broadcast_to(np.asarray(v, np.float64), (p,))
    m = np.broadcast_to(np.asarray(m, bool), (p,))
    if by == "zones":
        seg = ctx.seg
        if seg is None:
            seg = np.asarray(
                host_join(pts, host, index_system, resolution)
            )
        return host_fold_partial(v, m, seg, num_segments)
    cells = np.asarray(
        index_system.point_to_cell(pts, resolution)
    ).astype(np.int64)
    acc: dict = {}
    seg = np.where(m, cells, -1)
    _oracle_fold(acc, seg, v)
    return acc


def _band_rows(value: ast.Expr) -> dict:
    return {b: r for r, b in enumerate(ast.bands_of(value))}


def interpret_pair(node: ast.Expr, area, larea, rarea):
    """→ (value, valid) numpy arrays over per-pair tables — the f64
    mirror of `expr.compile._lower_pair`, op for op (div by zero under
    errstate-ignore so the oracle reaches the same inf/NaN bits)."""
    true = np.True_
    if isinstance(node, ast.Const):
        return np.float64(node.value), true
    if isinstance(node, ast.OverlapArea):
        return area, true
    if isinstance(node, ast.LeftArea):
        return larea, true
    if isinstance(node, ast.RightArea):
        return rarea, true
    if isinstance(node, (ast.BinOp, ast.Compare)):
        av, am = interpret_pair(node.a, area, larea, rarea)
        bv, bm = interpret_pair(node.b, area, larea, rarea)
        fn = _BIN[node.op] if isinstance(node, ast.BinOp) else _CMP[node.op]
        with np.errstate(divide="ignore", invalid="ignore"):
            return fn(av, bv), am & bm
    if isinstance(node, ast.BoolOp):
        av, am = interpret_pair(node.a, area, larea, rarea)
        bv, bm = interpret_pair(node.b, area, larea, rarea)
        return (av & bv) if node.op == "and" else (av | bv), am & bm
    if isinstance(node, ast.Not):
        av, am = interpret_pair(node.a, area, larea, rarea)
        return ~av, am
    if isinstance(node, ast.Where):
        cv, cm = interpret_pair(node.cond, area, larea, rarea)
        av, am = interpret_pair(node.a, area, larea, rarea)
        bv, bm = interpret_pair(node.b, area, larea, rarea)
        return np.where(cv, av, bv), cm & np.where(cv, am, bm)
    if isinstance(node, ast.MaskWhere):
        vv, vm = interpret_pair(node.value, area, larea, rarea)
        cv, cm = interpret_pair(node.cond, area, larea, rarea)
        return vv, vm & cm & cv
    raise TypeError(
        f"cannot interpret {type(node).__name__} in an overlay pair tree"
    )


def _general_pair_area(prep, lk: int, rk: int) -> float:
    """Exact f64 chip∩chip area through the native boolean-op engine —
    the catch-all for shapes the convex clip cannot answer (multi-ring,
    holed, over-pad, spilled)."""
    from ..core.geometry import hostops as _hostops
    from ..sql.overlay import _csr_geom_areas

    L, R = prep.left, prep.right
    ga = L.table.chips.take(np.asarray([int(L.rows[lk])]))
    gb = R.table.chips.take(np.asarray([int(R.rows[rk])]))
    inter = _hostops.intersection(ga, gb)
    return float(_csr_geom_areas(inter, prep.shift)[0])


def host_pair_override(prep, li, ri, valid, seg, flagged):
    """Whole-pair f64 re-answer for the flagged geometry pairs.

    For every candidate row of a flagged pair, recompute its area in
    pure f64 (cell/chip area tables for core kinds, the numpy twin of
    the convex clip for clippable border pairs, the native boolean-op
    engine otherwise) and accumulate per pair IN EMISSION ORDER — the
    same stream order both fold lanes use. Returns (len(flagged),) f64
    sums aligned with ``flagged``."""
    from ..kernels import overlay as _k

    flagged = np.asarray(flagged, np.int64)
    out = np.zeros(flagged.shape[0], np.float64)
    L, R = prep.left, prep.right
    seg = np.asarray(seg)
    mask = np.asarray(valid, bool) & (seg >= 0) & np.isin(seg, flagged)
    rows = np.nonzero(mask)[0]
    if not rows.size:
        return out
    lk = np.asarray(li, np.int64)[rows]
    rk = np.asarray(ri, np.int64)[rows]
    # ``flagged`` comes out of np.unique (sorted), so searchsorted maps
    # each row to its pair slot; np.add.at over ascending ``rows`` then
    # accumulates each pair's rows in emission order, the same order a
    # per-row python loop (and both fold lanes) would use
    pos = np.searchsorted(flagged, seg[rows])
    lcore, rcore = L.core[lk], R.core[rk]
    areas = np.zeros(rows.shape[0], np.float64)
    cc = lcore & rcore
    areas[cc] = L.cell_area[lk[cc]]
    cb = lcore & ~rcore
    areas[cb] = R.chip_area[rk[cb]]
    bc = ~lcore & rcore
    areas[bc] = L.chip_area[lk[bc]]
    bb = ~lcore & ~rcore
    ok = bb & L.ok_subj[lk] & R.ok_win[rk]
    general = np.nonzero(bb & ~ok)[0]
    if ok.any():
        # one batched numpy clip over every clippable row — elementwise
        # per row, so bit-identical to clipping them one at a time
        ar, _, sp = _k.clip_area_convex(
            L.verts[lk[ok]], L.vlen[lk[ok]],
            R.verts[rk[ok]], R.vlen[rk[ok]], xp=np,
        )
        areas[ok] = ar
        spilled = np.nonzero(ok)[0][np.asarray(sp, bool)]
        general = np.concatenate([general, spilled])
    for idx in general.tolist():
        # the rare catch-all: multi-ring / holed / over-pad shapes go
        # through the native boolean-op engine one pair at a time
        areas[idx] = _general_pair_area(prep, int(lk[idx]), int(rk[idx]))
    np.add.at(out, pos, areas)
    return out


def splice_override(prep, value, li, ri, valid, seg, host_needed,
                    seg_l64, seg_r64, val, vok, area64):
    """Replace every host-flagged pair's folded area AND evaluated value
    with the pure-f64 re-answer (shared by the device lane and its numpy
    twin, so both lanes splice identically). Returns ``(val, vok,
    area64, n_overridden)``."""
    seg = np.asarray(seg)
    flag_rows = (
        np.asarray(valid, bool) & (seg >= 0) & np.asarray(host_needed)
    )
    flagged = np.unique(seg[flag_rows])
    if not flagged.size:
        return val, vok, area64, 0
    over = host_pair_override(prep, li, ri, valid, seg, flagged)
    area64[flagged] = over
    fv, fm = interpret_pair(
        value, over, seg_l64[flagged], seg_r64[flagged]
    )
    val[flagged] = np.broadcast_to(
        np.asarray(fv, np.float64), flagged.shape
    )
    vok[flagged] = np.broadcast_to(np.asarray(fm, bool), flagged.shape)
    return val, vok, area64, int(flagged.size)


def host_overlay_measures(prep, value: ast.Expr, *, pair_cap=None):
    """Pure-host overlay measure lane: the numpy twin (``xp=np``) of the
    device pipeline, stage for stage — equi-join count/emission, kind-
    routed clip areas in the prep's accelerated dtype (so the host-
    recheck flags match), the sequential pair fold, the pair-tree
    interpretation, and the same f64 override splice. In f64 this IS
    the pure-f64 oracle the device lane must match bit for bit; it is
    also the degradation target when the device path fails. Returns the
    lane-output dict `sql.overlay.overlay_measures` packages."""
    from ..kernels import overlay as _k
    from ..sql import overlay as _ov

    L, R = prep.left, prep.right
    total = int(_k.pair_count(L.cells, R.cells, L.n, xp=np))
    Pb, emit_limit, overflow = _ov.pair_plan(total, pair_cap)
    li, ri, valid = _k.emit_pairs(
        L.cells, R.cells, L.n, emit_limit, Pb, xp=np
    )
    uniq, seg, sure, Sb, seg_l64, seg_r64 = _ov.pair_glue(
        prep, li, ri, valid
    )
    acc = np.dtype(prep.acc_name)
    area, host_needed = _k.pair_areas(
        L.core[li], R.core[ri], L.ok_subj[li], R.ok_win[ri],
        L.verts.astype(acc)[li], L.vlen[li],
        R.verts.astype(acc)[ri], R.vlen[ri],
        L.chip_area.astype(acc)[li], R.chip_area.astype(acc)[ri],
        L.cell_area.astype(acc)[li], acc.type(prep.band), xp=np,
    )
    _cnt, s = _k.host_pair_fold(area, valid, seg, Sb, acc_dtype=acc)
    fv, fm = interpret_pair(
        value, s, seg_l64.astype(acc), seg_r64.astype(acc)
    )
    val = np.broadcast_to(
        np.asarray(fv, np.float64), (Sb,)
    ).astype(np.float64).copy()
    vok = np.broadcast_to(np.asarray(fm, bool), (Sb,)).copy()
    area64 = s.astype(np.float64).copy()
    val, vok, area64, overridden = splice_override(
        prep, value, li, ri, valid, seg, host_needed,
        seg_l64, seg_r64, val, vok, area64,
    )
    U = uniq.shape[0]
    return {
        "pairs": uniq, "value": val[:U], "valid": vok[:U],
        "area": area64[:U], "sure": sure, "overflow": overflow,
        "host_overridden": overridden,
    }


def host_expr_zonal_oracle(
    raster, expr: ast.Expr, *, index_system, resolution,
    chip_index=None, tile=None, by: "str | None" = None,
) -> ZonalResult:
    """Pure-host f64 twin of `expr.eval.map_zonal`: interpret the same
    tree per tile, resolve membership through the exact f64 host join
    (zones) or point_to_cell (grid), fold sequentially per tile, merge
    with the same row-major left fold. Device results must match this
    bit for bit."""
    value, kind, term_by, _stats = ast.terminal_of(expr)
    if kind != "zonal":
        raise ValueError("host_expr_zonal_oracle folds zonal terminals")
    by = by or term_by
    host = None
    if chip_index is not None:
        host = getattr(chip_index, "host", None)
        if host is None and by == "zones":
            raise ValueError("chip_index carries no HostRecheck tables")
    ast.validate(
        expr, raster.num_bands, has_zones=chip_index is not None, by=by,
    )
    plan = plan_tiles(raster, tile)
    bands = ast.bands_of(value)
    rows = _band_rows(value)
    acc: dict = {}
    for _t, vals, mask, pts in _stack_band_views(raster, plan, bands):
        ctx = HostCtx(vals, mask, rows)
        _tile_ctx(ctx, value, pts, index_system, resolution,
                  host if by == "zones" else None)
        if by == "zones" and ctx.seg is None:
            ctx.seg = np.asarray(
                host_join(pts, host, index_system, resolution)
            )
        v, m = interpret(value, ctx)
        p = pts.shape[0]
        v = np.broadcast_to(np.asarray(v, np.float64), (p,))
        m = np.broadcast_to(np.asarray(m, bool), (p,))
        if by == "zones":
            key = ctx.seg
        else:
            key = np.asarray(
                index_system.point_to_cell(pts, resolution)
            ).astype(np.int64)
        seg = np.where(m & (key >= 0), key, -1)
        _oracle_fold(acc, seg, v)
    return _result_from_dict(acc, band=0)
