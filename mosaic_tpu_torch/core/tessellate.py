"""Tessellation engine: decompose geometries into grid-cell chips.

Reference analog: `core/Mosaic.scala` — `getChips` dispatches by geometry
type (`:21-35`), polygons go through `mosaicFill`'s buffer-and-carve
(`:60-87`: erode by the index buffer radius to find core cells, buffer the
boundary to find border cells, then intersect each border cell with the
geometry via JTS), lines through a BFS walk (`:146-194`), points to a single
cell (`:47-58`). Chips carry (is_core, cell_id, geometry)
(`core/types/model/MosaicChip.scala:20-76`).

The TPU-native redesign drops the buffer-and-carve heuristic for an *exact*
vectorized classification over candidate-cell batches:

    core    — every cell-boundary vertex inside the geometry, AND no
              geometry edge crosses a cell edge, AND no geometry vertex
              strictly inside the cell  ⇒  the whole (convex) cell is inside.
    outside — no contact at all (same three tests all empty, and the cell
              center outside).
    border  — everything else; chip geometry = geometry ∩ cell, computed by
              Sutherland–Hodgman clipping of each ring against the convex
              cell window (cells are squares or near-convex H3 hexagons —
              no general boolean op needed on the hot path).

This is stricter than the reference's contract: *every* core chip is provably
covered by its geometry (the reference's eroded-polyfill can only approximate
this; cf. `IndexSystem.getCoreChips` `core/index/IndexSystem.scala:181-186`).
Chip area is conserved: sum(core cell areas) + sum(border clip areas) equals
the geometry area — a property the tests assert.

All classification math is vectorized float64 numpy on host (this module
is a host copy of ``mosaic_tpu/core/tessellate.py``); the
device-resident analog for huge columns rides the same predicates through
the kernels. Clipping of concave rings may emit zero-width bridge
edges (standard Sutherland–Hodgman behavior); areas and point-in-polygon
parity are unaffected.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .index.base import IndexSystem
from .types import GeometryBuilder, GeometryType, PackedGeometry, ring_signed_area

_EPS = 1e-12


# --------------------------------------------------------------------------
# chip table
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ChipTable:
    """Exploded chip rows (reference: the rows `MosaicExplode` generates).

    geom_id[i] is the row index of the source geometry in the input column;
    chips holds one geometry per row (cell polygon for core chips when
    ``keep_core_geoms``, clipped intersection for border chips, clipped
    polyline/point for line/point chips). ``has_geom`` marks rows whose chip
    geometry was materialized (core chips with ``keep_core_geoms=False``
    store a placeholder empty polygon, like the reference's null geometry).
    """

    geom_id: np.ndarray  # (C,) int64
    cell_id: np.ndarray  # (C,) int64
    is_core: np.ndarray  # (C,) bool
    chips: PackedGeometry
    has_geom: np.ndarray  # (C,) bool

    def __len__(self) -> int:
        return int(self.geom_id.shape[0])


# --------------------------------------------------------------------------
# host geometry helpers (float64 exact-ish path)
# --------------------------------------------------------------------------
def _geom_rings(col: PackedGeometry, g: int) -> list[tuple[np.ndarray, bool, int]]:
    """[(ring_xy, is_hole, part_index)] for geometry g (open rings)."""
    out = []
    for p in col.geom_parts(g):
        for k, r in enumerate(col.part_rings(p)):
            out.append((col.ring_xy(r), k > 0, p))
    return out


def _even_odd_inside(pts: np.ndarray, rings: list[np.ndarray]) -> np.ndarray:
    """(M,) bool — even-odd crossing test of pts against a set of rings."""
    ea = [r for r in rings if r.shape[0] >= 3]
    if not ea:
        return np.zeros(pts.shape[0], dtype=bool)
    a = np.concatenate(ea)
    b = np.concatenate([np.roll(r, -1, axis=0) for r in ea])
    return _even_odd_edges(pts, a, b)


def _even_odd_edges(pts: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(M,) bool — even-odd parity of pts against an edge soup (E,2)x2.

    Parity over the concatenation of all rings equals the per-ring sum,
    so callers may prefilter the edge set to those that can actually
    cross a +x ray from the query region (y-overlap and not entirely
    left of it). Points are chunked so the dense (M, E) intermediates
    stay bounded for unprefiltered callers (polyfill over many-ring
    multipolygons)."""
    M, E = pts.shape[0], a.shape[0]
    if E == 0 or M == 0:
        return np.zeros(M, dtype=bool)
    out = np.zeros(M, dtype=bool)
    step = max(1, int(2e7 // E))
    for s in range(0, M, step):
        px, py = pts[s : s + step, 0][:, None], pts[s : s + step, 1][:, None]
        ay, by = a[None, :, 1], b[None, :, 1]
        straddle = (ay > py) != (by > py)
        denom = by - ay
        denom = np.where(denom == 0, 1.0, denom)
        xc = a[None, :, 0] + (py - ay) * (b[None, :, 0] - a[None, :, 0]) / denom
        out[s : s + step] = (np.sum(straddle & (px < xc), axis=1) & 1) == 1
    return out


def _segments_cross(a0, a1, b0, b1) -> np.ndarray:
    """Pairwise segment intersection (incl. touching): a* (E,2), b* (F,2) ->
    (E, F) bool."""

    def cross(o, d, p):
        # cross(d, p - o) for all pairs: o,d (E,2) vs p (F,2) -> (E,F)
        return d[:, None, 0] * (p[None, :, 1] - o[:, None, 1]) - d[:, None, 1] * (
            p[None, :, 0] - o[:, None, 0]
        )

    da = a1 - a0  # (E,2)
    db = b1 - b0  # (F,2)
    d1 = cross(a0, da, b0)  # orient of b0 wrt a
    d2 = cross(a0, da, b1)
    d3 = cross(b0, db, a0).T  # (E,F): orient of a0 wrt b
    d4 = cross(b0, db, a1).T
    proper = ((d1 > _EPS) != (d2 > _EPS)) & ((d3 > _EPS) != (d4 > _EPS)) & (
        (d1 < -_EPS) != (d2 < -_EPS)
    ) & ((d3 < -_EPS) != (d4 < -_EPS))

    def on_seg(o, d, p, c):
        # collinear (|c| <= eps) and p within o..o+d bbox
        lo = np.minimum(o, o + d)
        hi = np.maximum(o, o + d)
        inside = (
            (p[None, :, 0] >= lo[:, None, 0] - _EPS)
            & (p[None, :, 0] <= hi[:, None, 0] + _EPS)
            & (p[None, :, 1] >= lo[:, None, 1] - _EPS)
            & (p[None, :, 1] <= hi[:, None, 1] + _EPS)
        )
        return (np.abs(c) <= _EPS) & inside

    # touch handling is the expensive half (4 bbox masks) but only
    # matters where some orientation is collinear — skip it entirely for
    # the common all-proper case
    col = (
        (np.abs(d1) <= _EPS)
        | (np.abs(d2) <= _EPS)
        | (np.abs(d3) <= _EPS)
        | (np.abs(d4) <= _EPS)
    )
    if not col.any():
        return proper
    touch = (
        on_seg(a0, da, b0, d1)
        | on_seg(a0, da, b1, d2)
        | on_seg(b0, db, a0, d3.T).T
        | on_seg(b0, db, a1, d4.T).T
    )
    return proper | touch


def _in_convex(pts: np.ndarray, cell: np.ndarray) -> np.ndarray:
    """(M,) bool — pts strictly inside convex CCW polygon ``cell`` (k,2)."""
    a = cell
    b = np.roll(cell, -1, axis=0)
    d = b - a  # (k,2)
    s = d[None, :, 0] * (pts[:, None, 1] - a[None, :, 1]) - d[None, :, 1] * (
        pts[:, None, 0] - a[None, :, 0]
    )
    return np.all(s > _EPS, axis=1)


def _dedupe_boundary(bnd: np.ndarray) -> np.ndarray:
    """Strip repeated padding vertices from one cell boundary (B,2)->(k,2),
    oriented CCW."""
    keep = [0]
    for i in range(1, bnd.shape[0]):
        if not np.allclose(bnd[i], bnd[keep[-1]], atol=1e-14):
            keep.append(i)
    while len(keep) > 1 and np.allclose(bnd[keep[-1]], bnd[keep[0]], atol=1e-14):
        keep.pop()
    cell = bnd[keep]
    if cell.shape[0] >= 3 and ring_signed_area(cell) < 0:
        cell = cell[::-1]
    return cell


def _dedupe_boundaries_batch(
    bnds: np.ndarray, atol: float = 1e-14
) -> tuple[np.ndarray, np.ndarray]:
    """Batched `_dedupe_boundary`: (K, B, 2) padded boundaries →
    (cells (K, L, 2) CCW-oriented left-packed, klen (K,)).

    Index-system boundaries arrive padded by repeating vertices (closing
    vertex and/or trailing repeats), so consecutive-duplicate removal plus
    dropping the trailing run equal to vertex 0 reproduces the scalar
    helper's output for every real grid boundary.
    """
    K, B, _ = bnds.shape
    if K == 0:
        return np.zeros((0, 1, 2)), np.zeros(0, dtype=np.int64)
    diff = np.abs(bnds - np.roll(bnds, 1, axis=1)).max(axis=2) > atol  # (K,B)
    diff[:, 0] = True
    eq_first = np.abs(bnds - bnds[:, :1]).max(axis=2) <= atol  # (K,B)
    trailing = np.cumprod(eq_first[:, ::-1], axis=1)[:, ::-1].astype(bool)
    trailing[:, 0] = False
    keep = diff & ~trailing
    klen = keep.sum(axis=1).astype(np.int64)
    L = int(klen.max())
    cells = np.zeros((K, L, 2))
    pos = np.cumsum(keep, axis=1) - 1
    kk, jj = np.nonzero(keep)
    cells[kk, pos[kk, jj]] = bnds[kk, jj]
    # orient CCW: masked shoelace over the first klen vertices of each row
    idx = np.arange(L)[None, :]
    nxt = np.where(idx + 1 < klen[:, None], idx + 1, 0)
    nxt_xy = np.take_along_axis(cells, nxt[:, :, None], axis=1)
    valid = idx < klen[:, None]
    area2 = np.sum(
        np.where(
            valid,
            cells[:, :, 0] * nxt_xy[:, :, 1] - nxt_xy[:, :, 0] * cells[:, :, 1],
            0.0,
        ),
        axis=1,
    )
    flip = area2 < 0
    if flip.any():
        rev = np.where(
            idx < klen[:, None], klen[:, None] - 1 - idx, idx
        )  # reverse the valid prefix, keep pad slots in place
        reversed_cells = np.take_along_axis(cells, rev[:, :, None], axis=1)
        cells = np.where(flip[:, None, None], reversed_cells, cells)
    return cells, klen


def _classify_cells_batch(
    rings: list[tuple[np.ndarray, bool, int]],
    cells: np.ndarray,
    klen: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Batched `_classify_cells` over padded cell boundaries.

    cells (K, L, 2) left-packed convex CCW boundaries, klen (K,) valid
    vertex counts. Returns (is_core (K,), is_border (K,)). Same contract as
    the scalar version: core ⇔ all corners inside AND no edge crossing AND
    no geometry vertex strictly inside; border ⇔ any contact or center in.
    """
    K, L, _ = cells.shape
    ring_arrays = [r for r, _, _ in rings]
    gverts = np.concatenate(ring_arrays) if ring_arrays else np.zeros((0, 2))
    ea, eb = [], []
    for r in ring_arrays:
        if r.shape[0] >= 2:
            ea.append(r)
            eb.append(np.roll(r, -1, axis=0))
    ga = np.concatenate(ea) if ea else np.zeros((0, 2))
    gb = np.concatenate(eb) if eb else np.zeros((0, 2))

    idx = np.arange(L)[None, :]
    jmask = idx < klen[:, None]  # (K, L) valid vertices == valid edges
    centers = cells.sum(axis=1) / klen[:, None]
    corners_in = np.zeros((K, L), dtype=bool)
    centers_in = np.zeros(K, dtype=bool)

    nxt = np.where(idx + 1 < klen[:, None], idx + 1, 0)
    cb = np.take_along_axis(cells, nxt[:, :, None], axis=1)  # (K, L, 2)
    d = cb - cells

    vin = np.zeros(K, dtype=bool)
    crossing = np.zeros(K, dtype=bool)
    M = gverts.shape[0]
    E = ga.shape[0]
    # geometry-edge bboxes once, for the per-chunk locality prefilter
    if E:
        elo = np.minimum(ga, gb)
        ehi = np.maximum(ga, gb)
    # per-cell bboxes (padding masked out)
    big = np.where(jmask[:, :, None], cells, np.inf)
    small = np.where(jmask[:, :, None], cells, -np.inf)
    cell_lo = big.min(axis=1)  # (K, 2)
    cell_hi = small.max(axis=1)
    # chunk over cells so the (K, L, M) / (E, K*L) intermediates stay
    # bounded. For vertex-heavy geometries, additionally cap the chunk
    # small so its combined bbox keeps spatial locality (cell ids arrive
    # roughly spatially sorted) and the prefilter can reject most edges;
    # for small geometries the per-chunk overhead outweighs any rejection,
    # so keep one big vectorized pass (measured: 10-vertex zones were
    # 2.5x slower under an unconditional cap).
    chunk = max(1, int(2e7 // max(L * max(M, E), 1)))
    if max(M, E) >= 256:
        chunk = min(chunk, 8)
    for s in range(0, K, chunk):
        sl = slice(s, s + chunk)
        # locality prefilter: a res-9 cell chunk spans a tiny fraction of
        # the zone, so almost all geometry edges/vertices cannot touch it
        # — dropping them first shrinks the dense (E, k*L) / (k, L, M)
        # work by ~10x on the NYC zones
        lo = cell_lo[sl].min(axis=0) - _EPS
        hi = cell_hi[sl].max(axis=0) + _EPS
        if E:
            # corner/center even-odd parity, prefiltered to edges whose
            # y-range overlaps the chunk and that are not entirely to its
            # left (a +x ray can only cross those)
            pm = (
                (ehi[:, 1] >= lo[1])
                & (elo[:, 1] <= hi[1])
                & (ehi[:, 0] >= lo[0])
            )
            pa, pb = ga[pm], gb[pm]
            k = klen[sl].shape[0]
            pts = np.concatenate([cells[sl].reshape(-1, 2), centers[sl]])
            par = _even_odd_edges(pts, pa, pb)
            corners_in[sl] = par[: k * L].reshape(k, L)
            centers_in[sl] = par[k * L :]
        if M:
            vm = (
                (gverts[:, 0] >= lo[0])
                & (gverts[:, 0] <= hi[0])
                & (gverts[:, 1] >= lo[1])
                & (gverts[:, 1] <= hi[1])
            )
            gv = gverts[vm]
            if gv.shape[0]:
                sgn = d[sl, :, 0, None] * (
                    gv[None, None, :, 1] - cells[sl, :, 1, None]
                ) - d[sl, :, 1, None] * (
                    gv[None, None, :, 0] - cells[sl, :, 0, None]
                )
                strict = np.all(
                    (sgn > _EPS) | ~jmask[sl, :, None], axis=1
                )  # (k, M')
                vin[sl] = strict.any(axis=1)
        if E:
            em = ~(
                (ehi[:, 0] < lo[0])
                | (elo[:, 0] > hi[0])
                | (ehi[:, 1] < lo[1])
                | (elo[:, 1] > hi[1])
            )
            ga_c, gb_c = ga[em], gb[em]
            if ga_c.shape[0]:
                ca_f = cells[sl].reshape(-1, 2)
                cb_f = cb[sl].reshape(-1, 2)
                cm = _segments_cross(ga_c, gb_c, ca_f, cb_f)  # (E', k*L)
                cm &= jmask[sl].reshape(-1)[None, :]
                crossing[sl] = cm.any(axis=0).reshape(-1, L).any(axis=1)

    all_in = np.all(corners_in | ~jmask, axis=1)
    any_in = np.any(corners_in & jmask, axis=1)
    is_core = all_in & ~crossing & ~vin
    is_border = ~is_core & (any_in | crossing | vin | centers_in)
    return is_core, is_border


def clip_rings_convex_batch(
    ring: np.ndarray, cells: np.ndarray, klen: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Batched Sutherland–Hodgman: clip one open ring (n, 2) against K
    convex CCW cell windows at once.

    cells (K, L, 2) left-packed, klen (K,). Returns (out (K, C, 2), olen
    (K,)) — clipped rings, open form, olen=0 where the clip is empty
    (< 3 vertices). Equivalent to per-cell `clip_ring_convex` up to
    consecutive-duplicate vertices, which are removed at the end.
    """
    K, L, _ = cells.shape
    n = ring.shape[0]
    if K == 0 or n == 0:
        return np.zeros((K, 1, 2)), np.zeros(K, dtype=np.int64)
    # concave rings can emit 2 points per vertex against one half-plane, so
    # there is no small static bound; the buffer grows to each round's true
    # need (new_len.max()) below
    cur = np.zeros((K, n + L + 2, 2))
    cur[:, :n] = ring[None, :, :]
    clen = np.full(K, n, dtype=np.int64)
    for e in range(L):
        jdx = np.arange(cur.shape[1])[None, :]
        active = (e < klen) & (clen > 0)
        if not active.any():
            break
        ei = np.minimum(e, klen - 1)
        a = np.take_along_axis(cells, ei[:, None, None].repeat(2, 2), axis=1)[:, 0]
        bi = np.where(e + 1 < klen, e + 1, 0)
        b = np.take_along_axis(cells, bi[:, None, None].repeat(2, 2), axis=1)[:, 0]
        dx = (b[:, 0] - a[:, 0])[:, None]  # (K,1)
        dy = (b[:, 1] - a[:, 1])[:, None]
        s_cur = dx * (cur[:, :, 1] - a[:, 1][:, None]) - dy * (
            cur[:, :, 0] - a[:, 0][:, None]
        )  # (K, C)
        nxt = np.where(jdx + 1 < clen[:, None], jdx + 1, 0)
        nxt_xy = np.take_along_axis(cur, nxt[:, :, None], axis=1)
        s_nxt = np.take_along_axis(s_cur, nxt, axis=1)
        valid = jdx < clen[:, None]
        inside_cur = s_cur >= -_EPS
        inside_nxt = s_nxt >= -_EPS
        denom = s_cur - s_nxt
        denom = np.where(np.abs(denom) < _EPS, 1.0, denom)
        t = np.clip(s_cur / denom, 0.0, 1.0)[:, :, None]
        inter = cur + t * (nxt_xy - cur)  # (K, C, 2)
        emit0 = valid & inside_cur & active[:, None]
        emit1 = valid & (inside_cur != inside_nxt) & active[:, None]
        cnt = emit0.astype(np.int64) + emit1.astype(np.int64)
        base = np.cumsum(cnt, axis=1) - cnt  # exclusive
        new_len = cnt.sum(axis=1)
        # shrink the working width to the widest surviving ring: a tiny
        # convex window collapses most clipped rings after 2-3 half-planes,
        # so later rounds run on a fraction of the original ring width
        W = max(int(np.where(active, new_len, clen).max()), 1)
        buf = np.zeros((K, W, 2))
        k0, j0 = np.nonzero(emit0)
        buf[k0, base[k0, j0]] = cur[k0, j0]
        k1, j1 = np.nonzero(emit1)
        buf[k1, base[k1, j1] + emit0[k1, j1]] = inter[k1, j1]
        if W > cur.shape[1]:
            cur = np.pad(cur, ((0, 0), (0, W - cur.shape[1]), (0, 0)))
        elif W < cur.shape[1]:
            cur = np.ascontiguousarray(cur[:, :W])
        cur = np.where(active[:, None, None], buf, cur)
        clen = np.where(active, new_len, clen)
    jdx = np.arange(cur.shape[1])[None, :]
    # drop consecutive duplicates (cyclic), matching the scalar clipper
    prev = np.where(jdx - 1 >= 0, jdx - 1, np.maximum(clen[:, None] - 1, 0))
    prev_xy = np.take_along_axis(cur, prev[:, :, None], axis=1)
    dist = np.linalg.norm(cur - prev_xy, axis=2)
    keepv = (dist > 1e-13) & (jdx < clen[:, None])
    # fully-degenerate rings would drop every vertex; keep one (scalar
    # clipper's `out[:1]` fallback) so downstream length checks see it
    all_dropped = ~keepv.any(axis=1) & (clen > 0)
    keepv[:, 0] |= all_dropped
    olen = keepv.sum(axis=1).astype(np.int64)
    pos = np.cumsum(keepv, axis=1) - 1
    out = np.zeros_like(cur)
    kk, jj = np.nonzero(keepv)
    out[kk, pos[kk, jj]] = cur[kk, jj]
    olen = np.where(olen >= 3, olen, 0)
    return out, olen


def clip_ring_convex(ring: np.ndarray, cell: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip ``ring`` (n,2, open) to convex CCW ``cell``.

    Returns the clipped ring (m, 2), possibly empty. Output is open-form.
    """
    out = ring
    a = cell
    b = np.roll(cell, -1, axis=0)
    for i in range(cell.shape[0]):
        if out.shape[0] == 0:
            break
        ax, ay = a[i]
        dx, dy = b[i, 0] - ax, b[i, 1] - ay
        cur = out
        nxt = np.roll(cur, -1, axis=0)
        s_cur = dx * (cur[:, 1] - ay) - dy * (cur[:, 0] - ax)
        s_nxt = dx * (nxt[:, 1] - ay) - dy * (nxt[:, 0] - ax)
        pieces = []
        inside_cur = s_cur >= -_EPS
        inside_nxt = s_nxt >= -_EPS
        denom = s_cur - s_nxt
        denom = np.where(np.abs(denom) < _EPS, 1.0, denom)
        t = s_cur / denom
        inter = cur + np.clip(t, 0.0, 1.0)[:, None] * (nxt - cur)
        for j in range(cur.shape[0]):
            if inside_cur[j]:
                pieces.append(cur[j])
                if not inside_nxt[j]:
                    pieces.append(inter[j])
            elif inside_nxt[j]:
                pieces.append(inter[j])
        out = np.asarray(pieces).reshape(-1, 2)
        if out.shape[0]:
            # drop consecutive duplicates introduced at corners
            d = np.linalg.norm(out - np.roll(out, 1, axis=0), axis=1)
            out = out[d > 1e-13] if np.any(d > 1e-13) else out[:1]
    return out if out.shape[0] >= 3 else np.zeros((0, 2))


def clip_segments_convex(
    pts: np.ndarray, cell: np.ndarray
) -> list[np.ndarray]:
    """Clip an open polyline (n,2) to a convex CCW cell; returns the list of
    clipped sub-polylines (each (m>=2, 2)). Cyrus–Beck per segment, merged."""
    a = cell
    b = np.roll(cell, -1, axis=0)
    nrm = np.stack([-(b[:, 1] - a[:, 1]), b[:, 0] - a[:, 0]], axis=1)  # inward
    runs: list[np.ndarray] = []
    cur: list[np.ndarray] = []
    for i in range(pts.shape[0] - 1):
        p, q = pts[i], pts[i + 1]
        d = q - p
        t0, t1 = 0.0, 1.0
        ok = True
        for e in range(cell.shape[0]):
            den = float(np.dot(nrm[e], d))
            num = float(np.dot(nrm[e], a[e] - p))
            if abs(den) < _EPS:
                if num > _EPS:  # parallel & outside
                    ok = False
                    break
                continue
            t = num / den
            if den > 0:
                t0 = max(t0, t)
            else:
                t1 = min(t1, t)
            if t0 > t1 + _EPS:
                ok = False
                break
        if not ok:
            if len(cur) >= 2:
                runs.append(np.asarray(cur))
            cur = []
            continue
        c0 = p + max(t0, 0.0) * d
        c1 = p + min(t1, 1.0) * d
        if np.linalg.norm(c1 - c0) <= _EPS:
            continue
        if cur and np.allclose(cur[-1], c0, atol=1e-12):
            cur.append(c1)
        else:
            if len(cur) >= 2:
                runs.append(np.asarray(cur))
            cur = [c0, c1]
    if len(cur) >= 2:
        runs.append(np.asarray(cur))
    return runs


# --------------------------------------------------------------------------
# per-geometry-type chip generation
# --------------------------------------------------------------------------
def _classify_cells(
    rings: list[tuple[np.ndarray, bool, int]],
    cells_xy: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized core/border/outside classification for polygon rings.

    Returns (is_core (K,), is_border (K,)) over the candidate cells.
    """
    K = len(cells_xy)
    ring_arrays = [r for r, _, _ in rings]
    gverts = np.concatenate(ring_arrays) if ring_arrays else np.zeros((0, 2))
    # geometry edge list
    ea, eb = [], []
    for r in ring_arrays:
        if r.shape[0] >= 2:
            ea.append(r)
            eb.append(np.roll(r, -1, axis=0))
    ga = np.concatenate(ea) if ea else np.zeros((0, 2))
    gb = np.concatenate(eb) if eb else np.zeros((0, 2))

    is_core = np.zeros(K, dtype=bool)
    is_border = np.zeros(K, dtype=bool)
    # corner-in-geometry for all cells at once
    all_corners = np.concatenate(cells_xy) if K else np.zeros((0, 2))
    corner_off = np.cumsum([0] + [c.shape[0] for c in cells_xy])
    corners_in = _even_odd_inside(all_corners, ring_arrays)
    centers = np.asarray([c.mean(axis=0) for c in cells_xy]).reshape(-1, 2)
    centers_in = _even_odd_inside(centers, ring_arrays)
    for k, cell in enumerate(cells_xy):
        cin = corners_in[corner_off[k] : corner_off[k + 1]]
        # any geometry vertex strictly inside this cell?
        vin = bool(np.any(_in_convex(gverts, cell))) if gverts.shape[0] else False
        # any geometry edge touching any cell edge?
        ca = cell
        cb = np.roll(cell, -1, axis=0)
        crossing = (
            bool(np.any(_segments_cross(ga, gb, ca, cb))) if ga.shape[0] else False
        )
        if np.all(cin) and not crossing and not vin:
            is_core[k] = True
        elif np.any(cin) or crossing or vin or bool(centers_in[k]):
            is_border[k] = True
    return is_core, is_border


def _polygon_chips(
    col: PackedGeometry,
    g: int,
    cand: np.ndarray,
    cells: np.ndarray,
    klen: np.ndarray,
    keep_core_geoms: bool,
    out_geom_id: list,
    out_cell: list,
    out_core: list,
    out_hasgeom: list,
    builder: GeometryBuilder,
) -> None:
    """Chip one polygon geometry given its pre-batched candidate cells
    (``cand`` ids with deduped boundaries ``cells``/``klen``)."""
    rings = _geom_rings(col, g)
    ok = klen >= 3
    cand, cells, klen = cand[ok], cells[ok], klen[ok]
    if cand.size == 0:
        return
    is_core, is_border = _classify_cells_batch(rings, cells, klen)
    srid = int(col.srid[g])
    # clip every source ring against ALL border cells at once
    bpos = np.cumsum(is_border) - 1  # border-batch position per cell row
    bcells, bklen = cells[is_border], klen[is_border]
    ring_clips = [
        clip_rings_convex_batch(ring, bcells, bklen) for ring, _, _ in rings
    ]
    for k in range(len(cand)):
        if is_core[k]:
            out_geom_id.append(g)
            out_cell.append(int(cand[k]))
            out_core.append(True)
            out_hasgeom.append(keep_core_geoms)
            if keep_core_geoms:
                builder.add_geometry(
                    GeometryType.POLYGON, [[cells[k, : klen[k]]]], srid
                )
            else:
                builder.add_geometry(GeometryType.POLYGON, [[np.zeros((0, 2))]], srid)
        elif is_border[k]:
            # assemble clipped parts; keep nonempty shells with their holes
            t = int(bpos[k])
            parts_out = []
            cur_part = None
            cur_rings: list[np.ndarray] = []
            for (ring, is_hole, part), (cv, cl) in zip(rings, ring_clips):
                if part != cur_part:
                    if cur_rings:
                        parts_out.append(cur_rings)
                    cur_part, cur_rings = part, []
                m = int(cl[t])
                if m >= 3:
                    if not is_hole or cur_rings:
                        cur_rings.append(cv[t, :m])
                    # hole with no surviving shell: cell inside hole — but
                    # then it would not be border; skip defensively
            if cur_rings:
                parts_out.append(cur_rings)
            if not parts_out:
                continue  # grazing contact only — no area in this cell
            out_geom_id.append(g)
            out_cell.append(int(cand[k]))
            out_core.append(False)
            out_hasgeom.append(True)
            if len(parts_out) == 1:
                builder.add_geometry(GeometryType.POLYGON, [parts_out[0]], srid)
            else:
                builder.add_geometry(GeometryType.MULTIPOLYGON, parts_out, srid)


def _line_chips(
    col: PackedGeometry,
    g: int,
    index: IndexSystem,
    resolution: int,
    bounds: np.ndarray,
    out_geom_id: list,
    out_cell: list,
    out_core: list,
    out_hasgeom: list,
    builder: GeometryBuilder,
) -> None:
    """Reference analog: BFS `lineDecompose` (`core/Mosaic.scala:146-194`) —
    here: candidate cells over the bbox, clip the line to each, keep cells
    with nonempty clip. Line chips are never core."""
    cand = np.asarray(index.polyfill_candidates(bounds, resolution))
    if cand.size == 0:
        return
    bnds = np.asarray(index.cell_boundary(cand), dtype=np.float64)
    cells_b, klen_b = _dedupe_boundaries_batch(bnds)
    srid = int(col.srid[g])
    parts = [col.ring_xy(r) for p in col.geom_parts(g) for r in col.part_rings(p)]
    for k in range(len(cand)):
        if klen_b[k] < 3:
            continue
        cell = cells_b[k, : klen_b[k]]
        runs: list[np.ndarray] = []
        for pts in parts:
            runs.extend(clip_segments_convex(pts, cell))
        if not runs:
            continue
        out_geom_id.append(g)
        out_cell.append(int(cand[k]))
        out_core.append(False)
        out_hasgeom.append(True)
        if len(runs) == 1:
            builder.add_geometry(GeometryType.LINESTRING, [[runs[0]]], srid)
        else:
            builder.add_geometry(
                GeometryType.MULTILINESTRING, [[r] for r in runs], srid
            )


def _point_chips(
    col: PackedGeometry,
    g: int,
    index: IndexSystem,
    resolution: int,
    out_geom_id: list,
    out_cell: list,
    out_core: list,
    out_hasgeom: list,
    builder: GeometryBuilder,
    cells: "np.ndarray | None" = None,
) -> None:
    """Reference analog: `Mosaic.pointChip` (`core/Mosaic.scala:47-58`) —
    one non-core chip per point carrying the point geometry. ``cells``
    lets `tessellate` batch the cell assignment for ALL point geometries
    in one call (4104 per-geometry calls cost 7.2 s of a KNN transform)."""
    srid = int(col.srid[g])
    pts = col.geom_xy(g)
    if cells is None:
        cells = np.asarray(index.point_to_cell(pts, resolution)).reshape(-1)
    for i in range(pts.shape[0]):
        out_geom_id.append(g)
        out_cell.append(int(cells[i]))
        out_core.append(False)
        out_hasgeom.append(True)
        builder.add_geometry(GeometryType.POINT, [[pts[i : i + 1]]], srid)


def tessellate(
    col: PackedGeometry,
    index: IndexSystem,
    resolution: int,
    keep_core_geoms: bool = True,
) -> ChipTable:
    """Decompose every geometry in ``col`` into grid chips.

    Reference analog: `grid_tessellateexplode` / `MosaicExplode.eval`
    (`expressions/index/MosaicExplode.scala:70-79`) — but batch-first: one
    call chips a whole column.
    """
    resolution = index.resolution_arg(resolution)
    geom_id: list[int] = []
    cell: list[int] = []
    core: list[bool] = []
    hasgeom: list[bool] = []
    builder = GeometryBuilder()
    bounds = col.bounds()
    bases = [col.geometry_type(g).base for g in range(len(col))]
    # batch the index-system work for ALL polygons up front: candidates in
    # one fused call, then one cell_boundary + dedupe over every candidate
    poly_ids = [g for g in range(len(col)) if bases[g] == GeometryType.POLYGON]
    cand_of: dict[int, np.ndarray] = {}
    cells_of: dict[int, np.ndarray] = {}
    klen_of: dict[int, np.ndarray] = {}
    if poly_ids:
        cand_lists = index.polyfill_candidates_batch(bounds[poly_ids], resolution)
        sizes = [c.shape[0] for c in cand_lists]
        if sum(sizes):
            all_cand = np.concatenate(cand_lists)
            bnds = np.asarray(index.cell_boundary(all_cand), dtype=np.float64)
            cells_all, klen_all = _dedupe_boundaries_batch(bnds)
            off = np.cumsum([0] + sizes)
            for t, g in enumerate(poly_ids):
                sl = slice(off[t], off[t + 1])
                cand_of[g] = cand_lists[t]
                cells_of[g] = cells_all[sl]
                klen_of[g] = klen_all[sl]
    # batch cell assignment for ALL point geometries in one call
    point_ids = [
        g for g in range(len(col)) if bases[g] == GeometryType.POINT
    ]
    pcells_of: dict[int, np.ndarray] = {}
    if point_ids:
        psizes = [col.geom_xy(g).shape[0] for g in point_ids]
        if sum(psizes):
            allp = np.concatenate([col.geom_xy(g) for g in point_ids])
            cells_p = np.asarray(
                index.point_to_cell(allp, resolution)
            ).reshape(-1)
            poff = np.cumsum([0] + psizes)
            for t, g in enumerate(point_ids):
                pcells_of[g] = cells_p[poff[t] : poff[t + 1]]
    empty = (np.zeros(0, np.int64), np.zeros((0, 1, 2)), np.zeros(0, np.int64))
    for g in range(len(col)):
        base = bases[g]
        if base == GeometryType.POLYGON:
            cand = cand_of.get(g, empty[0])
            _polygon_chips(
                col,
                g,
                cand,
                cells_of.get(g, empty[1]),
                klen_of.get(g, empty[2]),
                keep_core_geoms,
                geom_id,
                cell,
                core,
                hasgeom,
                builder,
            )
        elif base == GeometryType.LINESTRING:
            _line_chips(
                col,
                g,
                index,
                resolution,
                bounds[g],
                geom_id,
                cell,
                core,
                hasgeom,
                builder,
            )
        elif base == GeometryType.POINT:
            _point_chips(
                col, g, index, resolution, geom_id, cell, core, hasgeom,
                builder, cells=pcells_of.get(g),
            )
        else:
            raise ValueError(f"cannot tessellate geometry type {base}")
    return ChipTable(
        geom_id=np.asarray(geom_id, dtype=np.int64),
        cell_id=np.asarray(cell, dtype=np.int64),
        is_core=np.asarray(core, dtype=bool),
        chips=builder.build(),
        has_geom=np.asarray(hasgeom, dtype=bool),
    )


def tessellate_subset(
    col: PackedGeometry,
    subset,
    index: IndexSystem,
    resolution: int,
    keep_core_geoms: bool = True,
    *,
    geom_ids=None,
) -> ChipTable:
    """Delta tessellation: chips for ``col[subset]`` only.

    The contract the epoch layer (`index/epoch.py`) builds on:
    :func:`tessellate` is per-geometry independent — the batched
    pre-passes (`polyfill_candidates_batch`, the fused boundary dedupe,
    the concatenated `point_to_cell`) partition per geometry, and every
    ``_*_chips`` emitter walks one geometry at a time — so the rows this
    returns are bit-identical to the matching geometry blocks of a full
    ``tessellate(col, ...)``, in the same within-block order
    (`tests/test_torch_epoch.py::TestDeltaTessellation` pins it).

    ``geom_ids`` relabels the emitted ``geom_id`` column (default: the
    ``subset`` positions themselves), so callers tessellating a
    standalone delta column can stamp rows with their stable ids.
    """
    subset = np.asarray(subset, dtype=np.int64).reshape(-1)
    labels = (
        subset
        if geom_ids is None
        else np.asarray(geom_ids, dtype=np.int64).reshape(-1)
    )
    if labels.shape != subset.shape:
        raise ValueError(
            f"geom_ids has {labels.shape[0]} labels for "
            f"{subset.shape[0]} subset geometries"
        )
    sub = col.take([int(p) for p in subset])
    t = tessellate(sub, index, resolution, keep_core_geoms)
    return ChipTable(
        geom_id=labels[t.geom_id],
        cell_id=t.cell_id,
        is_core=t.is_core,
        chips=t.chips,
        has_geom=t.has_geom,
    )


def polyfill(
    col: PackedGeometry, index: IndexSystem, resolution: int
) -> tuple[np.ndarray, np.ndarray]:
    """Centroid-rule polyfill: cells whose center lies inside each geometry.

    Reference analog: `Polyfill` expression → H3 JNI polyfill
    (`core/index/H3IndexSystem.scala:113-126`; centroid semantics) and BNG's
    centroid BFS (`core/index/BNGIndexSystem.scala:180-204`).

    Returns CSR ``(cells (T,), offsets (G+1,))``.
    """
    resolution = index.resolution_arg(resolution)
    all_cells: list[np.ndarray] = []
    offsets = [0]
    bounds = col.bounds()
    for g in range(len(col)):
        base = col.geometry_type(g).base
        if base != GeometryType.POLYGON:
            offsets.append(offsets[-1])
            all_cells.append(np.zeros(0, np.int64))
            continue
        cand = np.asarray(index.polyfill_candidates(bounds[g], resolution))
        if cand.size == 0:
            offsets.append(offsets[-1])
            all_cells.append(np.zeros(0, np.int64))
            continue
        centers = np.asarray(index.cell_center(cand), dtype=np.float64)
        rings = [r for r, _, _ in _geom_rings(col, g)]
        inside = _even_odd_inside(centers, rings)
        kept = np.unique(cand[inside])
        all_cells.append(kept)
        offsets.append(offsets[-1] + kept.size)
    return (
        np.concatenate(all_cells) if all_cells else np.zeros(0, np.int64),
        np.asarray(offsets, dtype=np.int64),
    )
