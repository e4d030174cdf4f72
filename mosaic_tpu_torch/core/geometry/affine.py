"""Whole-column affine transforms on packed geometry.

Port of ``mosaic_tpu/core/geometry/affine.py`` (a copy kept
in the port so that it never imports the JAX package); reprojection goes
through the port's own CRS modules (``core/crs*.py``).

Reference analog: `ST_Rotate`/`ST_Scale`/`ST_Translate`
(`expressions/geometry/ST_Rotate.scala` etc.), which apply a JTS
AffineTransformation per row. Here the transform is one vectorized pass over
the shared ``(V, 2)`` vertex buffer — every geometry in the column at once —
with per-geometry parameters broadcast through the CSR offsets.
"""

from __future__ import annotations

import numpy as np

from ..types import PackedGeometry


def _per_vertex(col: PackedGeometry, vals) -> np.ndarray:
    """Broadcast per-geometry scalars (or one scalar) to per-vertex."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.ndim == 0:
        return np.full(col.num_vertices, float(vals))
    counts = col.vertices_per_geom()
    return np.repeat(vals, counts)


def _with_xy(col: PackedGeometry, xy: np.ndarray) -> PackedGeometry:
    return PackedGeometry(
        xy=xy,
        ring_offsets=col.ring_offsets,
        part_offsets=col.part_offsets,
        geom_offsets=col.geom_offsets,
        geom_type=col.geom_type,
        srid=col.srid,
        z=col.z,
        geom_has_z=col.geom_has_z,
    )


def translate(col: PackedGeometry, dx, dy) -> PackedGeometry:
    """Shift each geometry by (dx, dy); scalars or per-geometry arrays."""
    xy = col.xy.copy()
    xy[:, 0] += _per_vertex(col, dx)
    xy[:, 1] += _per_vertex(col, dy)
    return _with_xy(col, xy)


def scale(col: PackedGeometry, sx, sy) -> PackedGeometry:
    """Scale about the origin (JTS AffineTransformation.scale semantics)."""
    xy = col.xy.copy()
    xy[:, 0] *= _per_vertex(col, sx)
    xy[:, 1] *= _per_vertex(col, sy)
    return _with_xy(col, xy)


def rotate(col: PackedGeometry, theta) -> PackedGeometry:
    """Rotate about the origin by ``theta`` radians (CCW), per JTS rotate."""
    t = _per_vertex(col, theta)
    c, s = np.cos(t), np.sin(t)
    x, y = col.xy[:, 0], col.xy[:, 1]
    return _with_xy(col, np.stack([c * x - s * y, s * x + c * y], axis=-1))


def transform_srid(col: PackedGeometry, to_srid: int) -> PackedGeometry:
    """Reproject every geometry to ``to_srid`` (reference: ST_Transform /
    MosaicGeometry.transformCRSXY `core/geometry/MosaicGeometry.scala:102-128`).

    Geometries already in the target SRID pass through untouched; mixed-SRID
    columns are handled group-by-group over the vertex buffer.
    """
    from .. import crs

    xy = col.xy.copy()
    counts = col.vertices_per_geom()
    vert_srid = np.repeat(col.srid, counts)
    for s in np.unique(vert_srid):
        if int(s) == int(to_srid):
            continue
        m = vert_srid == s
        xy[m] = crs.transform_points(xy[m], int(s), int(to_srid))
    out = _with_xy(col, xy)
    out.srid = np.full_like(col.srid, to_srid)
    return out


def set_srid(col: PackedGeometry, srid: int) -> PackedGeometry:
    """Relabel SRID without moving coordinates (reference: ST_SetSRID)."""
    out = _with_xy(col, col.xy)
    out.srid = np.full_like(col.srid, srid)
    return out
