"""Host exact-geometry engine: the ctypes seam to the native boolean ops.

Port of the part of ``mosaic_tpu/core/geometry/hostops.py`` the overlay
join reads: :func:`intersection` (row-wise polygon ∩ polygon) through the
repo's C++ Martinez–Rueda sweep (`native/src/martinez.cpp`, built with
``make -C native`` on first use), plus the shell/hole nesting of its flat
even-odd contours. The marshaling is the reference's line for line, so
both packages get the same f64 vertices from the same library. Buffer,
union and the other ops are ROADMAP queue 1 item 14.
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

OP_INTERSECTION = 0

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
    l.mg_free_result.restype = None
    l.mg_free_result.argtypes = [_c_dpp, _c_lpp]
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
def bool_op(op: int, a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    """Row-wise polygon boolean op between two equal-length columns,
    through the native Martinez sweep (`mg_bool_op`)."""
    if len(a) != len(b):
        raise ValueError("columns must have equal length")
    l = lib()
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
