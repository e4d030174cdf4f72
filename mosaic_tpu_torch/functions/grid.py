"""grid_ index functions.

Port of ``mosaic_tpu/functions/grid.py``. The point-to-cell hot path,
:func:`grid_longlatascellid`, runs on the device (the card unless the
caller passes ``device="cpu"``) and returns a tensor there, where the
reference returns a ``jax.Array``; the rest is host numpy over the
index system, as in the reference.

Reference analog: the 15 expressions under `expressions/index/`
(MosaicExplode, MosaicFill, Polyfill, PointIndexLonLat/Geom, IndexGeometry,
GridDistance, CellKRing/KLoop + Geometry variants + explode forms) registered
at `functions/MosaicContext.scala:101-424`. All cell ids are int64 on device;
string formatting happens only through :func:`grid_format_cellid` /
``cell_id_type='string'`` at the host edge (the reference's Long/String
duality, `functions/MosaicContext.scala:41-48`).
"""

from __future__ import annotations

import numpy as np

from ..core.index.base import IndexSystem
from ..core.tessellate import ChipTable, polyfill as _polyfill, tessellate as _tessellate
from ..core.types import GeometryBuilder, GeometryType
from ._coerce import as_points, serialize, to_packed

__all__ = [
    "grid_longlatascellid", "grid_pointascellid", "grid_polyfill",
    "grid_tessellate", "grid_tessellateexplode", "grid_boundary",
    "grid_boundaryaswkb", "grid_cellkring", "grid_cellkloop",
    "grid_cellkringexplode", "grid_cellkloopexplode", "grid_geometrykring",
    "grid_geometrykloop", "grid_geometrykringexplode",
    "grid_geometrykloopexplode", "grid_distance", "grid_cell_center",
    "grid_format_cellid", "grid_parse_cellid", "grid_resolution",
    "grid_is_valid_cellid",
]


def _index(index: IndexSystem | None) -> IndexSystem:
    if index is not None:
        return index
    from ..context import current_context

    return current_context().index_system


def _cells(cells, index: IndexSystem | None = None) -> np.ndarray:
    arr = np.asarray(cells)
    if arr.dtype.kind in "US" or arr.dtype == object:
        return (
            _index(index)
            .parse([str(c) for c in arr.ravel()])
            .reshape(arr.shape)
        )
    return arr.astype(np.int64)


# ------------------------------------------------------------ point -> cell


def grid_longlatascellid(lon, lat, resolution, index: IndexSystem | None = None,
                         device=None):
    """(N,) lon, (N,) lat -> (N,) int64 cells on the device — the
    billion-row hot path (reference: PointIndexLonLat -> H3 geoToH3 JNI,
    `core/index/H3IndexSystem.scala:140-142`). The coordinates keep their
    dtype (float64 for a float64 column, as the reference's under x64)."""
    import torch

    from .. import resolve_device

    idx = _index(index)
    dev = resolve_device(device)
    xy = torch.stack(
        [torch.as_tensor(lon, device=dev), torch.as_tensor(lat, device=dev)], dim=-1
    )
    return torch.as_tensor(
        idx.point_to_cell(xy, idx.resolution_arg(resolution)), device=dev
    )


def grid_pointascellid(geom, resolution, index: IndexSystem | None = None):
    """POINT column -> cell ids (reference: PointIndexGeom)."""
    idx = _index(index)
    pts = as_points(geom)
    return np.asarray(
        idx.point_to_cell(pts, idx.resolution_arg(resolution)), dtype=np.int64
    )


# ------------------------------------------------------------- cell -> geom


def grid_boundary(cells, fmt: str = "wkt", index: IndexSystem | None = None):
    """Cell boundary polygons (reference: IndexGeometry, any output format)."""
    idx = _index(index)
    arr = _cells(cells, idx)
    bnd = np.asarray(idx.cell_boundary(arr), dtype=np.float64)  # (N,B,2)
    b = GeometryBuilder()
    for i in range(arr.shape[0]):
        ring = bnd[i]
        # drop padded repeats of the final vertex
        keep = np.ones(ring.shape[0], dtype=bool)
        for j in range(ring.shape[0] - 1, 0, -1):
            if np.array_equal(ring[j], ring[j - 1]):
                keep[j] = False
            else:
                break
        b.add_geometry(GeometryType.POLYGON, [[ring[keep]]], idx.crs_srid)
    return serialize(b.build(), fmt)


def grid_boundaryaswkb(cells, index: IndexSystem | None = None):
    return grid_boundary(cells, fmt="wkb", index=index)


def grid_cell_center(cells, index: IndexSystem | None = None) -> np.ndarray:
    idx = _index(index)
    return np.asarray(idx.cell_center(_cells(cells, idx)), dtype=np.float64)


# ---------------------------------------------------------------- polyfill


def grid_polyfill(geom, resolution, index: IndexSystem | None = None):
    """Cells whose center is inside each geometry; CSR (cells, offsets)
    (reference: Polyfill -> H3 polyfill JNI)."""
    idx = _index(index)
    return _polyfill(to_packed(geom), idx, idx.resolution_arg(resolution))


# ------------------------------------------------------------- tessellation


def grid_tessellate(
    geom,
    resolution,
    keep_core_geoms: bool = True,
    index: IndexSystem | None = None,
) -> ChipTable:
    """Chip decomposition of a geometry column (reference: MosaicFill /
    grid_tessellate, `expressions/index/MosaicFill.scala:81-92`)."""
    idx = _index(index)
    return _tessellate(
        to_packed(geom), idx, idx.resolution_arg(resolution), keep_core_geoms
    )


def grid_tessellateexplode(
    geom,
    resolution,
    keep_core_geoms: bool = True,
    index: IndexSystem | None = None,
) -> ChipTable:
    """Alias of :func:`grid_tessellate` — the chip table is
    already exploded (one row per chip), like MosaicExplode's generator rows."""
    return grid_tessellate(geom, resolution, keep_core_geoms, index)


# ------------------------------------------------------------ rings / loops


def grid_cellkring(cells, k: int, index: IndexSystem | None = None) -> np.ndarray:
    """(N, M) padded k-disk per cell, -1 pads (reference: CellKRing)."""
    idx = _index(index)
    return np.asarray(idx.k_ring(_cells(cells, idx), int(k)))


def grid_cellkloop(cells, k: int, index: IndexSystem | None = None) -> np.ndarray:
    """(N, M) hollow ring at distance exactly k (reference: CellKLoop)."""
    idx = _index(index)
    return np.asarray(idx.k_loop(_cells(cells, idx), int(k)))


def _explode(ids_padded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    rows, cols = np.nonzero(ids_padded >= 0)
    return rows.astype(np.int64), ids_padded[rows, cols]


def grid_cellkringexplode(cells, k: int, index: IndexSystem | None = None):
    """Flat (row_ids, neighbor_cells) pairs (reference: CellKRingExplode)."""
    return _explode(grid_cellkring(cells, k, index))


def grid_cellkloopexplode(cells, k: int, index: IndexSystem | None = None):
    return _explode(grid_cellkloop(cells, k, index))


def _geometry_cells(geom, resolution, idx: IndexSystem) -> list[np.ndarray]:
    """Per-geometry cell cover: polyfill ∪ boundary cells (the reference's
    `Mosaic.geometryKRing` seeds from the full chip set,
    `core/Mosaic.scala:111-144`)."""
    col = to_packed(geom)
    table = _tessellate(col, idx, resolution, keep_core_geoms=False)
    return [
        np.unique(table.cell_id[table.geom_id == g]) for g in range(len(col))
    ]


def grid_geometrykring(
    geom, resolution, k: int, index: IndexSystem | None = None
) -> list[np.ndarray]:
    """Per-row cell set: k-ring around every cell touching the geometry
    (reference: GeometryKRing, `core/Mosaic.scala:111-127`)."""
    idx = _index(index)
    res = idx.resolution_arg(resolution)
    out = []
    for seed in _geometry_cells(geom, res, idx):
        if not seed.size:
            out.append(seed)
            continue
        rings = np.asarray(idx.k_ring(seed, int(k)))
        out.append(np.unique(rings[rings >= 0]))
    return out


def grid_geometrykloop(
    geom, resolution, k: int, index: IndexSystem | None = None
) -> list[np.ndarray]:
    """k-ring minus (k-1)-ring of the geometry cover (reference:
    GeometryKLoop / `Mosaic.geometryKLoop` `core/Mosaic.scala:129-144`)."""
    idx = _index(index)
    res = idx.resolution_arg(resolution)
    out = []
    for seed in _geometry_cells(geom, res, idx):
        if not seed.size:
            out.append(seed)
            continue
        outer = np.asarray(idx.k_ring(seed, int(k)))
        outer = np.unique(outer[outer >= 0])
        if k >= 1:
            inner = np.asarray(idx.k_ring(seed, int(k) - 1))
            inner = np.unique(inner[inner >= 0])
            outer = np.setdiff1d(outer, inner, assume_unique=True)
        out.append(outer)
    return out


def _explode_ragged(groups: list[np.ndarray]):
    rows = np.concatenate(
        [np.full(len(g), i, dtype=np.int64) for i, g in enumerate(groups)]
    ) if groups else np.zeros(0, np.int64)
    vals = np.concatenate(groups) if groups else np.zeros(0, np.int64)
    return rows, vals


def grid_geometrykringexplode(geom, resolution, k, index=None):
    return _explode_ragged(grid_geometrykring(geom, resolution, k, index))


def grid_geometrykloopexplode(geom, resolution, k, index=None):
    return _explode_ragged(grid_geometrykloop(geom, resolution, k, index))


# ------------------------------------------------------------------- misc


def grid_distance(cells_a, cells_b, index: IndexSystem | None = None) -> np.ndarray:
    """Grid distance between cell pairs (reference: GridDistance)."""
    idx = _index(index)
    return np.asarray(
        idx.grid_distance(_cells(cells_a, idx), _cells(cells_b, idx))
    )


def grid_resolution(cells, index: IndexSystem | None = None) -> np.ndarray:
    idx = _index(index)
    return np.asarray(idx.resolution_of(_cells(cells, idx)))


def grid_is_valid_cellid(cells, index: IndexSystem | None = None) -> np.ndarray:
    idx = _index(index)
    return np.asarray(idx.is_valid(_cells(cells, idx)))


def grid_format_cellid(cells, index: IndexSystem | None = None) -> list[str]:
    """int64 -> canonical string ids (H3 hex, BNG refs)."""
    return _index(index).format(np.asarray(cells, dtype=np.int64))


def grid_parse_cellid(strs, index: IndexSystem | None = None) -> np.ndarray:
    return _index(index).parse(list(strs))


# ------------------------------------------------------- legacy v0.2 aliases
# The reference keeps its pre-rename function names registered as aliases
# (`functions/MosaicContext.scala:419-424`, `grid_tessellateaslong` :304-308);
# a user migrating old notebooks finds the same names here.
polyfill = grid_polyfill
mosaicfill = grid_tessellate
mosaic_explode = grid_tessellateexplode
grid_tessellateaslong = grid_tessellate  # cell ids are int64 already
point_index_geom = grid_pointascellid
point_index_lonlat = grid_longlatascellid
index_geometry = grid_boundaryaswkb

__all__ += [
    "polyfill", "mosaicfill", "mosaic_explode", "grid_tessellateaslong",
    "point_index_geom", "point_index_lonlat", "index_geometry",
]
