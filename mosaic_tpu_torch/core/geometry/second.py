"""Second geometry engine bindings — the ESRI-engine role.

Port of ``mosaic_tpu/core/geometry/second.py``, line for line (a copy kept
in the port so that it never imports the JAX package).

The reference ships two complete geometry engines (JTS and ESRI,
`core/geometry/api/GeometryAPI.scala:24-60`) and its tests cross-check
expression results between them. This module is that second engine for
the port: an independent C++ implementation (`native/src/evalgeom.cpp` —
separate language, Kahan-compensated numerics, half-open edge rule) of the
core measures and predicates, exposed with the same per-geometry API shape
as :mod:`mosaic_tpu_torch.core.geometry.oracle` so tests and the ``native``
function backend can swap it in directly.

Selectable API-wide via ``MosaicConfig(geometry_backend="native")`` —
functions without a native implementation fall back to the numpy oracle
(documented per function in `functions/geometry.py`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..types import GeometryType, PackedGeometry
from . import hostops

_c_dpp = ctypes.POINTER(ctypes.c_double)
_c_lpp = ctypes.POINTER(ctypes.c_int64)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)

_proto = False


def _lib() -> ctypes.CDLL:
    """The shared native library with the eval entry points declared."""
    global _proto
    l = hostops.lib()
    if not _proto:
        l.mg_eval_polygon.restype = ctypes.c_int
        l.mg_eval_polygon.argtypes = [
            _c_dpp, _c_lpp, ctypes.c_int64, _c_u8p, _c_dpp,
        ]
        l.mg_eval_length.restype = ctypes.c_int
        l.mg_eval_length.argtypes = [_c_dpp, _c_lpp, ctypes.c_int64, _c_dpp]
        l.mg_eval_bounds.restype = ctypes.c_int
        l.mg_eval_bounds.argtypes = [_c_dpp, ctypes.c_int64, _c_dpp]
        l.mg_eval_contains.restype = ctypes.c_int
        l.mg_eval_contains.argtypes = [
            _c_dpp, _c_lpp, ctypes.c_int64, _c_dpp, ctypes.c_int64, _c_u8p,
        ]
        l.mg_eval_distance.restype = ctypes.c_int
        l.mg_eval_distance.argtypes = [
            _c_dpp, _c_lpp, ctypes.c_int64, _c_dpp, ctypes.c_int64, _c_dpp,
        ]
        l.mg_eval_clip.restype = ctypes.c_int
        l.mg_eval_clip.argtypes = [
            ctypes.c_int,
            _c_dpp, _c_lpp, ctypes.c_int64,
            _c_dpp, _c_lpp, ctypes.c_int64,
            ctypes.POINTER(_c_dpp), ctypes.POINTER(_c_lpp),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _c_i32p = ctypes.POINTER(ctypes.c_int32)
        l.mg_eval_pip_join.restype = ctypes.c_int
        l.mg_eval_pip_join.argtypes = [
            _c_dpp, _c_lpp,                      # xy, ro
            _c_lpp, ctypes.c_int64,              # cro, nchips
            _c_u8p, _c_i32p,                     # chip_core, chip_geom
            _c_lpp, ctypes.c_int64,              # cells, ncells
            _c_i32p, ctypes.c_int64,             # cell_rows, max_chips
            _c_dpp, _c_lpp, ctypes.c_int64,      # pts, pcells, npts
            _c_i32p,                             # out
        ]
        _proto = True
    return l


def chip_index_csr(border_verts, ring_len):
    """CSR rings from a padded chip column for :func:`eval_pip_join`.

    border_verts: (C, R, V, 2); ring_len: (C, R) real vertex counts (the
    closing vertex is excluded — the C side wraps rings implicitly).
    Returns (xy (nv, 2) f64-contiguous, ro (nr+1,) i64, cro (C+1,) i64).
    """
    bv = np.asarray(border_verts, dtype=np.float64)
    bl = np.asarray(ring_len)
    V = bv.shape[2]
    vmask = np.arange(V)[None, None, :] < bl[:, :, None]  # (C, R, V)
    xy = np.ascontiguousarray(bv[vmask])  # row-major: chip, ring, vertex
    rmask = bl > 0
    ro = np.zeros(int(rmask.sum()) + 1, dtype=np.int64)
    np.cumsum(bl[rmask], out=ro[1:])
    cro = np.zeros(bl.shape[0] + 1, dtype=np.int64)
    np.cumsum(rmask.sum(axis=1), out=cro[1:])
    return xy, ro, cro


def eval_pip_join(xy, ro, cro, chip_core, chip_geom, cells, cell_rows, pts, pcells):
    """Single-thread C++ reference-shaped PIP join (the bench baseline
    lane): cell equi-join by binary search + per-chip `is_core ||
    contains` over clipped chip rings — the closest runnable analog of
    the reference's JTS codegen row path
    (`core/geometry/MosaicGeometryJTS.scala:101`)."""
    lib = _lib()
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    ro = np.ascontiguousarray(ro, dtype=np.int64)
    cro = np.ascontiguousarray(cro, dtype=np.int64)
    chip_core = np.ascontiguousarray(chip_core, dtype=np.uint8)
    chip_geom = np.ascontiguousarray(chip_geom, dtype=np.int32)
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    cell_rows = np.ascontiguousarray(cell_rows, dtype=np.int32)
    pts = np.ascontiguousarray(pts, dtype=np.float64)
    pcells = np.ascontiguousarray(pcells, dtype=np.int64)
    out = np.empty(pts.shape[0], dtype=np.int32)
    _c_i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.mg_eval_pip_join(
        xy.ctypes.data_as(_c_dpp), ro.ctypes.data_as(_c_lpp),
        cro.ctypes.data_as(_c_lpp), ctypes.c_int64(cro.shape[0] - 1),
        chip_core.ctypes.data_as(_c_u8p), chip_geom.ctypes.data_as(_c_i32p),
        cells.ctypes.data_as(_c_lpp), ctypes.c_int64(cells.shape[0]),
        cell_rows.ctypes.data_as(_c_i32p),
        ctypes.c_int64(cell_rows.shape[1]),
        pts.ctypes.data_as(_c_dpp), pcells.ctypes.data_as(_c_lpp),
        ctypes.c_int64(pts.shape[0]),
        out.ctypes.data_as(_c_i32p),
    )
    if rc != 0:
        raise RuntimeError(f"mg_eval_pip_join rc={rc}")
    return out


def _geom_contours(col: PackedGeometry, g: int):
    """(xy (V,2) f64, ring_off (R+1,) i64, is_hole (R,) u8) of geometry g.

    Marshaling reuses hostops' flattening; only the hole flags (first ring
    of each part = shell) are collected here."""
    holes = [
        1 if k > 0 else 0
        for p in col.geom_parts(g)
        for k, _ in enumerate(col.part_rings(p))
    ]
    xy, ro = hostops._flatten(hostops._geom_rings(col, g))
    return xy, ro, np.asarray(holes, dtype=np.uint8)


def _poly4(col: PackedGeometry, g: int) -> np.ndarray:
    xy, ro, hole = _geom_contours(col, g)
    out = np.full(4, np.nan)
    if ro.shape[0] > 1:
        _lib().mg_eval_polygon(
            xy.ctypes.data_as(_c_dpp),
            ro.ctypes.data_as(_c_lpp),
            ctypes.c_int64(ro.shape[0] - 1),
            hole.ctypes.data_as(_c_u8p),
            out.ctypes.data_as(_c_dpp),
        )
    else:
        out[:] = (0.0, 0.0, np.nan, np.nan)
    return out


def _is_poly(col: PackedGeometry, g: int) -> bool:
    return col.geometry_type(g).base == GeometryType.POLYGON


def area(col: PackedGeometry) -> np.ndarray:
    """Polygon area, holes subtracted; 0 for non-polygonal rows."""
    return np.asarray(
        [_poly4(col, g)[0] if _is_poly(col, g) else 0.0 for g in range(len(col))]
    )


def centroid(col: PackedGeometry) -> np.ndarray:
    """Area-weighted centroid for polygons; vertex/segment means (host
    numpy, same as the oracle — the C engine covers the polygonal case)
    for points and lines."""
    from . import oracle as _oracle

    out = np.zeros((len(col), 2))
    for g in range(len(col)):
        if _is_poly(col, g):
            out[g] = _poly4(col, g)[2:4]
        else:
            out[g] = _oracle.centroid(col.slice(g, g + 1))[0]
    return out


def length(col: PackedGeometry) -> np.ndarray:
    """Perimeter for polygons, chain length for lines, 0 for points —
    the `st_length` contract."""
    l = _lib()
    out = np.zeros(len(col))
    for g in range(len(col)):
        base = col.geometry_type(g).base
        if base == GeometryType.POINT:
            continue
        if base == GeometryType.POLYGON:
            out[g] = _poly4(col, g)[1]
            continue
        xy, ro, _ = _geom_contours(col, g)
        if ro.shape[0] <= 1:
            continue
        v = np.zeros(1)
        l.mg_eval_length(
            xy.ctypes.data_as(_c_dpp),
            ro.ctypes.data_as(_c_lpp),
            ctypes.c_int64(ro.shape[0] - 1),
            v.ctypes.data_as(_c_dpp),
        )
        out[g] = v[0]
    return out


def bounds(col: PackedGeometry) -> np.ndarray:
    l = _lib()
    out = np.full((len(col), 4), np.nan)
    for g in range(len(col)):
        xy, _, _ = _geom_contours(col, g)
        if not xy.shape[0]:
            continue
        l.mg_eval_bounds(
            xy.ctypes.data_as(_c_dpp),
            ctypes.c_int64(xy.shape[0]),
            out[g].ctypes.data_as(_c_dpp),
        )
    return out


def contains_points(col: PackedGeometry, g: int, pts: np.ndarray) -> np.ndarray:
    xy, ro, _ = _geom_contours(col, g)
    p = np.ascontiguousarray(np.asarray(pts, dtype=np.float64))
    out = np.zeros(p.shape[0], np.uint8)
    if ro.shape[0] > 1 and p.shape[0]:
        _lib().mg_eval_contains(
            xy.ctypes.data_as(_c_dpp),
            ro.ctypes.data_as(_c_lpp),
            ctypes.c_int64(ro.shape[0] - 1),
            p.ctypes.data_as(_c_dpp),
            ctypes.c_int64(p.shape[0]),
            out.ctypes.data_as(_c_u8p),
        )
    return out.astype(bool)


def clip(op: int, a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    """Row-wise polygon boolean op via the INDEPENDENT edge-classification
    clipper (`mg_eval_clip`) — the witness for `hostops.bool_op`'s
    Martinez sweep. Same op codes (0=intersection 1=union 2=difference
    3=xor); marshaling/nesting shared through `hostops.bool_op` (the
    engine independence lives in the C clippers, not the Python seam)."""
    return hostops.bool_op(op, a, b, fn=_lib().mg_eval_clip)


def intersection(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return clip(hostops.OP_INTERSECTION, a, b)


def union(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return clip(hostops.OP_UNION, a, b)


def difference(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return clip(hostops.OP_DIFFERENCE, a, b)


def sym_difference(a: PackedGeometry, b: PackedGeometry) -> PackedGeometry:
    return clip(hostops.OP_XOR, a, b)


def point_distance(col: PackedGeometry, g: int, pts: np.ndarray) -> np.ndarray:
    """Distance from each point to geometry g (0 inside)."""
    xy, ro, _ = _geom_contours(col, g)
    p = np.ascontiguousarray(np.asarray(pts, dtype=np.float64))
    out = np.full(p.shape[0], np.nan)
    if ro.shape[0] > 1 and p.shape[0]:
        _lib().mg_eval_distance(
            xy.ctypes.data_as(_c_dpp),
            ro.ctypes.data_as(_c_lpp),
            ctypes.c_int64(ro.shape[0] - 1),
            p.ctypes.data_as(_c_dpp),
            ctypes.c_int64(p.shape[0]),
            out.ctypes.data_as(_c_dpp),
        )
    return out
