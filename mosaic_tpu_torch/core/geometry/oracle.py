"""Host (numpy, float64) oracle implementations of geometry ops.

Port of ``mosaic_tpu/core/geometry/oracle.py``: the straightforward
per-geometry numpy measures (:func:`area`, :func:`length`,
:func:`centroid`, :func:`bounds`) and point predicates that the
``oracle`` function backend answers with and the device measures are held
against, plus the exact row-wise pair predicates the reference keeps in
``functions/geometry.py``: :func:`pair_contains`,
:func:`pair_intersects` (which `sql/overlay.py intersects_join` refines
candidates with) and
:func:`pair_distance` (which `models/knn.py` degrades to on the CPU).
The ring walk :func:`_rings` is read by `runtime/quarantine.py`.
"""

from __future__ import annotations

import numpy as np

from ..types import GeometryType, PackedGeometry, ring_signed_area


def _rings(col: PackedGeometry, g: int):
    """Yield ``(k, (V, 2) xy)`` for every ring of geometry ``g``: ``k`` is
    the ring's index within its part (0 = outer ring)."""
    for p in col.geom_parts(g):
        for k, r in enumerate(col.part_rings(p)):
            yield k, col.ring_xy(r)


def _oriented(xy: np.ndarray, hole: bool) -> np.ndarray:
    if xy.shape[0] >= 3:
        sa = ring_signed_area(xy)
        if (sa < 0) != hole:
            return xy[::-1]
    return xy


def area(col: PackedGeometry) -> np.ndarray:
    """(G,) f64 area of each polygon (holes subtracted); 0 for points and
    lines."""
    out = np.zeros(len(col))
    for g in range(len(col)):
        if col.geometry_type(g).base != GeometryType.POLYGON:
            continue
        tot = 0.0
        for k, xy in _rings(col, g):
            a = abs(ring_signed_area(xy))
            tot += -a if k > 0 else a
        out[g] = tot
    return out


def length(col: PackedGeometry) -> np.ndarray:
    out = np.zeros(len(col))
    for g in range(len(col)):
        base = col.geometry_type(g).base
        if base == GeometryType.POINT:
            continue
        tot = 0.0
        for _, xy in _rings(col, g):
            if base == GeometryType.POLYGON and xy.shape[0] >= 2:
                xy = np.vstack([xy, xy[:1]])
            tot += float(np.sum(np.linalg.norm(np.diff(xy, axis=0), axis=1)))
        out[g] = tot
    return out


def centroid(col: PackedGeometry) -> np.ndarray:
    """(G, 2) f64 centroid: the area-weighted one of a polygon, the
    length-weighted one of a line, the mean vertex otherwise."""
    out = np.zeros((len(col), 2))
    for g in range(len(col)):
        base = col.geometry_type(g).base
        if base == GeometryType.POLYGON:
            a6 = 0.0
            c = np.zeros(2)
            for k, xy in _rings(col, g):
                xy = _oriented(xy, k > 0)
                xyc = np.vstack([xy, xy[:1]])
                p, q = xyc[:-1], xyc[1:]
                cross = p[:, 0] * q[:, 1] - q[:, 0] * p[:, 1]
                c += np.sum((p + q) * cross[:, None], axis=0)
                a6 += 3.0 * np.sum(cross)
            out[g] = c / a6 if a6 != 0 else np.mean(col.geom_xy(g), axis=0)
        elif base == GeometryType.LINESTRING:
            num = np.zeros(2)
            den = 0.0
            for _, xy in _rings(col, g):
                seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
                mid = 0.5 * (xy[:-1] + xy[1:])
                num += np.sum(mid * seg[:, None], axis=0)
                den += float(np.sum(seg))
            out[g] = num / den if den else np.mean(col.geom_xy(g), axis=0)
        else:
            out[g] = np.mean(col.geom_xy(g), axis=0)
    return out


def point_in_polygon(col: PackedGeometry, g: int, pt: np.ndarray) -> bool:
    """Even-odd ray crossing over all rings of polygon g (boundary excluded
    per crossing parity; boundary points may go either way in f64)."""
    x, y = float(pt[0]), float(pt[1])
    inside = False
    for _, xy in _rings(col, g):
        n = xy.shape[0]
        if n < 3:
            continue
        j = n - 1
        for i in range(n):
            xi, yi = xy[i]
            xj, yj = xy[j]
            if (yi > y) != (yj > y):
                xcross = xi + (y - yi) * (xj - xi) / (yj - yi)
                if x < xcross:
                    inside = not inside
            j = i
    return inside


def contains_points(col: PackedGeometry, g: int, pts: np.ndarray) -> np.ndarray:
    return np.array([point_in_polygon(col, g, p) for p in np.atleast_2d(pts)])


def bounds(col: PackedGeometry) -> np.ndarray:
    return col.bounds()


def _rings_of(col: PackedGeometry, g: int) -> list:
    return [
        col.ring_xy(r) for p in col.geom_parts(g) for r in col.part_rings(p)
    ]


def _edges_of(rings: list, closed: bool):
    segs = []
    for r in rings:
        if r.shape[0] < 2:
            continue
        pts = np.vstack([r, r[:1]]) if closed else r
        segs.append((pts[:-1], pts[1:]))
    if not segs:
        return np.zeros((0, 2)), np.zeros((0, 2))
    return (np.concatenate([s[0] for s in segs]),
            np.concatenate([s[1] for s in segs]))


def _rings_cross(ra, rb, ta: GeometryType, tb: GeometryType) -> bool:
    from ..tessellate import _segments_cross

    a0, a1 = _edges_of(ra, ta.base == GeometryType.POLYGON)
    b0, b1 = _edges_of(rb, tb.base == GeometryType.POLYGON)
    if not a0.shape[0] or not b0.shape[0]:
        return False
    return bool(np.any(_segments_cross(a0, a1, b0, b1)))


def pair_contains(a: PackedGeometry, b: PackedGeometry) -> np.ndarray:
    """(G,) bool row-wise a contains b, exact in f64 — the reference's
    ``st_contains(..., backend="oracle")``: every vertex of b inside a
    (even-odd) and no boundary crossing or touch."""
    from ..tessellate import _even_odd_inside

    n = len(a)
    out = np.zeros(n, dtype=bool)
    for g in range(n):
        ra, rb = _rings_of(a, g), _rings_of(b, g)
        pts = b.geom_xy(g)
        if not pts.shape[0] or not ra:
            continue
        if not _even_odd_inside(pts, ra).all():
            continue
        out[g] = not _rings_cross(ra, rb, a.geometry_type(g), b.geometry_type(g))
    return out


def pair_intersects(a: PackedGeometry, b: PackedGeometry) -> np.ndarray:
    """(G,) bool row-wise intersects of two equal-length columns, exact in
    f64 — the reference's ``st_intersects(..., backend="oracle")``
    (`functions/geometry.py _oracle_pair_intersects`): any boundary
    crossing or touch, else any vertex of one inside the other polygon."""
    from ..tessellate import _even_odd_inside

    n = len(a)
    out = np.zeros(n, dtype=bool)
    for g in range(n):
        ra, rb = _rings_of(a, g), _rings_of(b, g)
        pa, pb = a.geom_xy(g), b.geom_xy(g)
        if not pa.shape[0] or not pb.shape[0]:
            continue
        if _rings_cross(ra, rb, a.geometry_type(g), b.geometry_type(g)):
            out[g] = True
            continue
        # no boundary crossing: intersects iff ANY vertex of one lies inside
        # the other (covers multi-part geometries with nested parts)
        in_a = (
            a.geometry_type(g).base == GeometryType.POLYGON
            and bool(_even_odd_inside(pb, ra).any())
        )
        in_b = (
            b.geometry_type(g).base == GeometryType.POLYGON
            and bool(_even_odd_inside(pa, rb).any())
        )
        out[g] = bool(in_a or in_b)
    return out


def point_boundary_distance(col: PackedGeometry, g: int, pt: np.ndarray) -> float:
    """Min distance from ``pt`` to any boundary edge of geometry ``g``
    (f64 host)."""
    p = np.asarray(pt, dtype=np.float64)
    closed = col.geometry_type(g).base == GeometryType.POLYGON
    best = np.inf
    for _, xy in _rings(col, g):
        if xy.shape[0] == 0:
            continue
        if xy.shape[0] == 1:
            best = min(best, float(np.linalg.norm(xy[0] - p)))
            continue
        a = xy if closed else xy[:-1]
        b = np.roll(xy, -1, axis=0) if closed else xy[1:]
        d = b - a
        l2 = np.sum(d * d, axis=1)
        l2 = np.where(l2 == 0, 1.0, l2)
        t = np.clip(np.sum((p - a) * d, axis=1) / l2, 0.0, 1.0)
        proj = a + t[:, None] * d
        best = min(best, float(np.min(np.linalg.norm(proj - p, axis=1))))
    return best


def pair_distance(a: PackedGeometry, b: PackedGeometry) -> np.ndarray:
    """(G,) row-wise euclidean distance of two equal-length columns, 0
    where they intersect, exact in f64 — the reference's
    ``st_distance(..., backend="oracle")``."""
    n = len(a)
    out = np.zeros(n)
    inter = pair_intersects(a, b)
    for g in range(n):
        if inter[g]:
            continue
        pa, pb = a.geom_xy(g), b.geom_xy(g)
        da = min((point_boundary_distance(b, g, p) for p in pa), default=np.inf)
        db = min((point_boundary_distance(a, g, p) for p in pb), default=np.inf)
        out[g] = min(da, db)
    return out
