"""Host exact-geometry engine: boolean ops, buffer, hull, simplify.

Port of ``mosaic_tpu/core/geometry/hostops.py``, line for line (a copy kept
in the port so that it never imports the JAX package).

Role of JTS/ESRI in the reference (`core/geometry/MosaicGeometryJTS.scala:
61-101` — intersection/union/difference/buffer/simplify/convexHull). These
are the irreducibly sequential, branchy geometry algorithms that do not map
to the card's array units; they stay on host C++ while predicates/measures/
tessellation-classification run on device. The C++ core
(`native/src/martinez.cpp`) implements Martinez–Rueda sweep-line boolean
operations; this module is the ctypes seam plus shell/hole nesting.

Geometries are exchanged with C++ as flat even-odd contour lists; nesting
back into polygon-with-holes structure happens here via containment parity.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from ..types import (
    GeometryBuilder,
    GeometryType,
    PackedGeometry,
    ring_signed_area,
)

_REPO = Path(__file__).resolve().parents[3]
_SO = _REPO / "native" / "build" / "libmosaicgeom.so"

_lib = None

OP_INTERSECTION, OP_UNION, OP_DIFFERENCE, OP_XOR = 0, 1, 2, 3

_c_dpp = ctypes.POINTER(ctypes.c_double)
_c_lpp = ctypes.POINTER(ctypes.c_int64)


def lib() -> ctypes.CDLL:
    """Load (building on first use) the native geometry library."""
    global _lib
    if _lib is not None:
        return _lib
    # always invoke make: it is incremental, so source edits rebuild and a
    # fresh checkout builds, at the cost of one no-op subprocess per process
    proc = subprocess.run(
        ["make", "-C", str(_REPO / "native")], capture_output=True, text=True
    )
    if proc.returncode != 0:
        raise RuntimeError(f"native geometry build failed:\n{proc.stderr}")
    l = ctypes.CDLL(str(_SO))
    l.mg_bool_op.restype = ctypes.c_int
    l.mg_bool_op.argtypes = [
        ctypes.c_int,
        _c_dpp, _c_lpp, ctypes.c_int64,
        _c_dpp, _c_lpp, ctypes.c_int64,
        ctypes.POINTER(_c_dpp), ctypes.POINTER(_c_lpp),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    l.mg_buffer.restype = ctypes.c_int
    l.mg_buffer.argtypes = [
        _c_dpp, _c_lpp, ctypes.c_int64, ctypes.c_int,
        ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(_c_dpp), ctypes.POINTER(_c_lpp),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    l.mg_union_many.restype = ctypes.c_int
    l.mg_union_many.argtypes = [
        _c_dpp, _c_lpp, ctypes.c_int64, _c_lpp, ctypes.c_int64,
        ctypes.POINTER(_c_dpp), ctypes.POINTER(_c_lpp),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    l.mg_free_result.restype = None
    l.mg_free_result.argtypes = [_c_dpp, _c_lpp]
    l.mg_convex_hull.restype = ctypes.c_int64
    l.mg_convex_hull.argtypes = [_c_dpp, ctypes.c_int64, _c_dpp]
    l.mg_simplify_mask.restype = ctypes.c_int64
    l.mg_simplify_mask.argtypes = [
        _c_dpp, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = l
    return l


# ---------------------------------------------------------------- marshaling
def _geom_rings(col: PackedGeometry, g: int) -> list[np.ndarray]:
    out = []
    for p in col.geom_parts(g):
        for r in col.part_rings(p):
            out.append(col.ring_xy(r))
    return out


def _flatten(rings: list[np.ndarray]):
    if not rings:
        return (
            np.zeros((0, 2)),
            np.zeros(1, np.int64),
        )
    xy = np.ascontiguousarray(np.concatenate(rings), dtype=np.float64)
    ro = np.zeros(len(rings) + 1, np.int64)
    np.cumsum([r.shape[0] for r in rings], out=ro[1:])
    return xy, ro


def _as_ptr(xy: np.ndarray, ro: np.ndarray):
    return (
        xy.ctypes.data_as(_c_dpp),
        ro.ctypes.data_as(_c_lpp),
        ctypes.c_int64(ro.shape[0] - 1),
    )


def _read_result(l, oxy, oro, onv, onr) -> list[np.ndarray]:
    nv, nr = onv.value, onr.value
    if nr == 0:
        l.mg_free_result(oxy, oro)
        return []
    xy = np.ctypeslib.as_array(oxy, shape=(nv, 2)).copy()
    ro = np.ctypeslib.as_array(oro, shape=(nr + 1,)).copy()
    l.mg_free_result(oxy, oro)
    return [xy[ro[r] : ro[r + 1]] for r in range(nr)]


def _point_in_ring(pt: np.ndarray, ring: np.ndarray) -> bool:
    x, y = pt
    a = ring
    b = np.roll(ring, -1, axis=0)
    cond = (a[:, 1] > y) != (b[:, 1] > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xs = a[:, 0] + (y - a[:, 1]) * (b[:, 0] - a[:, 0]) / (b[:, 1] - a[:, 1])
    return bool(np.count_nonzero(cond & (x < xs)) % 2)


def _contour_in_ring(ci: np.ndarray, cj: np.ndarray) -> bool:
    """Is contour ``ci`` inside ring ``cj``? Result contours touch but never
    cross, so one point decides — but a vertex of one contour routinely lies
    ON the other (shared topology), where ray-casting parity is arbitrary
    (observed: a union's clipped-hole corner vertex got nested as its own
    shell, inflating the area). Test a candidate point of ``ci`` that is
    well clear of ``cj``'s boundary: scan vertices + edge midpoints one at
    a time (O(|cj|) memory, usually one iteration) and stop at the first
    candidate farther than eps, falling back to the farthest seen."""
    a = cj
    ab = np.roll(cj, -1, axis=0) - a
    den = np.maximum((ab * ab).sum(axis=1), 1e-300)
    span = cj.max(axis=0) - cj.min(axis=0)
    eps2 = (1e-7 * max(float(span[0]), float(span[1]), 1e-300)) ** 2
    mids = 0.5 * (ci + np.roll(ci, -1, axis=0))
    best_pt, best_d2 = ci[0], -1.0
    for k in range(2 * ci.shape[0]):
        pt = ci[k // 2] if k % 2 == 0 else mids[k // 2]
        ap = pt - a
        t = np.clip((ap * ab).sum(axis=1) / den, 0.0, 1.0)
        close = a + t[:, None] * ab
        d2 = float(((pt - close) ** 2).sum(axis=1).min())
        if d2 > best_d2:
            best_d2, best_pt = d2, pt
        if d2 > eps2:
            break
    return _point_in_ring(best_pt, cj)


def _nest_contours(contours: list[np.ndarray]) -> list[list[np.ndarray]]:
    """Group flat even-odd contours into [[shell, hole...], ...] polygons.

    Depth of a contour = how many other contours contain it (even-odd). Even
    depth ⇒ shell; odd ⇒ hole of its innermost containing shell.
    """
    n = len(contours)
    if n == 0:
        return []
    if n == 1:
        c = contours[0]
        return [[c if ring_signed_area(c) >= 0 else c[::-1]]]
    inside = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for j in range(n):
            if i != j:
                inside[i, j] = _contour_in_ring(contours[i], contours[j])
    depth = inside.sum(axis=1)
    polys: list[list[np.ndarray]] = []
    shell_ids = [i for i in range(n) if depth[i] % 2 == 0]
    id_to_poly = {}
    for i in shell_ids:
        c = contours[i]
        id_to_poly[i] = len(polys)
        polys.append([c if ring_signed_area(c) >= 0 else c[::-1]])
    for i in range(n):
        if depth[i] % 2 == 1:
            # innermost containing shell: containing shell of max depth
            cands = [j for j in shell_ids if inside[i, j]]
            if not cands:
                continue
            parent = max(cands, key=lambda j: depth[j])
            c = contours[i]
            polys[id_to_poly[parent]].append(
                c if ring_signed_area(c) < 0 else c[::-1]
            )
    return polys


def _emit_polygon(b: GeometryBuilder, polys: list[list[np.ndarray]], srid: int):
    """Append a (MULTI)POLYGON (or empty POLYGON) built from nested rings."""
    if not polys:
        b.add_geometry(GeometryType.POLYGON, [[np.zeros((0, 2))]], srid)
    elif len(polys) == 1:
        b.add_geometry(GeometryType.POLYGON, [polys[0]], srid)
    else:
        b.add_geometry(GeometryType.MULTIPOLYGON, polys, srid)


def _is_polygonal(col: PackedGeometry, g: int) -> bool:
    return col.geometry_type(g).base == GeometryType.POLYGON


# ------------------------------------------------------------- public column ops
def bool_op(
    op: int, a: PackedGeometry, b: PackedGeometry, fn=None
) -> PackedGeometry:
    """Row-wise polygon boolean op between two equal-length columns.

    ``fn`` selects the C entry point — default `mg_bool_op` (the Martinez
    sweep); `second.clip` passes `mg_eval_clip` (the independent witness
    clipper) so both engines share this one marshaling seam."""
    if len(a) != len(b):
        raise ValueError("columns must have equal length")
    l = lib()
    if fn is None:
        fn = l.mg_bool_op
    out = GeometryBuilder()
    for g in range(len(a)):
        if not (_is_polygonal(a, g) and _is_polygonal(b, g)):
            raise NotImplementedError(
                "boolean ops are implemented for polygonal geometries; "
                f"got {a.geometry_type(g).name} × {b.geometry_type(g).name}"
            )
        axy, aro = _flatten(_geom_rings(a, g))
        bxy, bro = _flatten(_geom_rings(b, g))
        oxy, oro = _c_dpp(), _c_lpp()
        onv, onr = ctypes.c_int64(), ctypes.c_int64()
        rc = fn(
            op, *_as_ptr(axy, aro), *_as_ptr(bxy, bro),
            ctypes.byref(oxy), ctypes.byref(oro),
            ctypes.byref(onv), ctypes.byref(onr),
        )
        if rc != 0:
            raise MemoryError("boolean-op native call failed")
        contours = _read_result(l, oxy, oro, onv, onr)
        _emit_polygon(out, _nest_contours(contours), int(a.srid[g]))
    return out.build()


def intersection(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return bool_op(OP_INTERSECTION, a, b)


def union(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return bool_op(OP_UNION, a, b)


def difference(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return bool_op(OP_DIFFERENCE, a, b)


def sym_difference(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return bool_op(OP_XOR, a, b)


def buffer(
    col: PackedGeometry, dist: float, quad_segs: int = 8
) -> PackedGeometry:
    """Round-join buffer. Polygons: Minkowski via edge-capsule union (exact
    up to arc polygonization, matching JTS's segmentized arcs); negative
    distances erode. Points/lines: union of edge capsules."""
    l = lib()
    out = GeometryBuilder()
    for g in range(len(col)):
        closed = 1 if _is_polygonal(col, g) else 0
        rings = _geom_rings(col, g)
        xy, ro = _flatten(rings)
        oxy, oro = _c_dpp(), _c_lpp()
        onv, onr = ctypes.c_int64(), ctypes.c_int64()
        rc = l.mg_buffer(
            *_as_ptr(xy, ro), closed, float(dist), int(quad_segs),
            ctypes.byref(oxy), ctypes.byref(oro),
            ctypes.byref(onv), ctypes.byref(onr),
        )
        if rc != 0:
            raise MemoryError("mg_buffer failed")
        contours = _read_result(l, oxy, oro, onv, onr)
        _emit_polygon(out, _nest_contours(contours), int(col.srid[g]))
    return out.build()


def unary_union(col: PackedGeometry) -> PackedGeometry:
    """Per-row union of a geometry's own parts (reference: ST_UnaryUnion)."""
    l = lib()
    out = GeometryBuilder()
    for g in range(len(col)):
        if not _is_polygonal(col, g):
            out.append_from(col, g)
            continue
        parts = []
        for p in col.geom_parts(g):
            parts.append([col.ring_xy(r) for r in col.part_rings(p)])
        contours = _union_groups(l, parts)
        _emit_polygon(out, _nest_contours(contours), int(col.srid[g]))
    return out.build()


def union_all(col: PackedGeometry, srid: int | None = None) -> PackedGeometry:
    """Union of every polygonal row into one geometry (ST_Union_Agg)."""
    l = lib()
    groups = []
    for g in range(len(col)):
        if not _is_polygonal(col, g):
            raise NotImplementedError("union_all expects polygonal rows")
        groups.append(_geom_rings(col, g))
    contours = _union_groups(l, groups)
    out = GeometryBuilder()
    _emit_polygon(
        out, _nest_contours(contours),
        int(col.srid[0]) if (srid is None and len(col)) else int(srid or 0),
    )
    return out.build()


def _union_groups(l, groups: list[list[np.ndarray]]) -> list[np.ndarray]:
    rings = [r for grp in groups for r in grp]
    xy, ro = _flatten(rings)
    go = np.zeros(len(groups) + 1, np.int64)
    np.cumsum([len(grp) for grp in groups], out=go[1:])
    oxy, oro = _c_dpp(), _c_lpp()
    onv, onr = ctypes.c_int64(), ctypes.c_int64()
    rc = l.mg_union_many(
        *_as_ptr(xy, ro), go.ctypes.data_as(_c_lpp), ctypes.c_int64(len(groups)),
        ctypes.byref(oxy), ctypes.byref(oro),
        ctypes.byref(onv), ctypes.byref(onr),
    )
    if rc != 0:
        raise MemoryError("mg_union_many failed")
    return _read_result(l, oxy, oro, onv, onr)


def convex_hull(col: PackedGeometry) -> PackedGeometry:
    l = lib()
    out = GeometryBuilder()
    for g in range(len(col)):
        pts = np.ascontiguousarray(col.geom_xy(g), dtype=np.float64)
        n = pts.shape[0]
        buf = np.zeros((max(2 * n, 1), 2))
        k = l.mg_convex_hull(
            pts.ctypes.data_as(_c_dpp), ctypes.c_int64(n),
            buf.ctypes.data_as(_c_dpp),
        )
        hull = buf[:k]
        srid = int(col.srid[g])
        if k >= 3:
            out.add_geometry(GeometryType.POLYGON, [[hull]], srid)
        elif k == 2:
            out.add_geometry(GeometryType.LINESTRING, [[hull]], srid)
        else:
            out.add_geometry(GeometryType.POINT, [[hull[:1]]], srid)
    return out.build()


def simplify(col: PackedGeometry, tol: float) -> PackedGeometry:
    """Douglas–Peucker per ring (reference: JTS DouglasPeuckerSimplifier)."""
    l = lib()
    out = GeometryBuilder()
    for g in range(len(col)):
        gt = col.geometry_type(g)
        if gt.base == GeometryType.POINT:
            out.append_from(col, g)
            continue
        closed = 1 if gt.base == GeometryType.POLYGON else 0
        for p in col.geom_parts(g):
            for r in col.part_rings(p):
                ring = np.ascontiguousarray(col.ring_xy(r), dtype=np.float64)
                n = ring.shape[0]
                keep = np.zeros(n, dtype=np.uint8)
                l.mg_simplify_mask(
                    ring.ctypes.data_as(_c_dpp), ctypes.c_int64(n),
                    ctypes.c_double(tol), closed,
                    keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                )
                kept = ring[keep.astype(bool)]
                if closed and kept.shape[0] < 3:
                    kept = ring  # refuse to collapse a ring
                out.add_ring(kept)
            out.end_part()
        out.end_geom(gt, int(col.srid[g]))
    return out.build()
