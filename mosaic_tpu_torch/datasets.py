"""Synthetic benchmark datasets.

The reference benchmarks against NYC taxi zones × yellow-trip pickup points
(`notebooks/examples/scala/QuickstartNotebook.scala:149-216`,
`src/test/resources/NYC_Taxi_Zones.geojson`). The real fixtures are not
shipped here, so these generators produce workloads with the same shape:
a few hundred simple (possibly concave) polygon "zones" tiling the NYC
bounding box, and uniformly random pickup points over the same extent.
"""

from __future__ import annotations

import numpy as np

from .core.types import GeometryBuilder, GeometryType, PackedGeometry

NYC_BBOX = (-74.3, 40.4, -73.6, 41.0)


def synthetic_zones(
    nx: int = 16,
    ny: int = 16,
    bbox: tuple[float, float, float, float] = NYC_BBOX,
    seed: int = 7,
    verts: int = 10,
    jitter: float = 0.45,
    srid: int = 4326,
) -> PackedGeometry:
    """A lattice of ``nx*ny`` star-shaped polygons covering ``bbox``.

    Each zone is a simple polygon (sorted angles, jittered radii — may be
    concave, which exercises the clipper the way real taxi-zone shorelines
    do). Adjacent zones overlap slightly, like real zone boundaries digitized
    at different scales.
    """
    rng = np.random.default_rng(seed)
    xmin, ymin, xmax, ymax = bbox
    dx = (xmax - xmin) / nx
    dy = (ymax - ymin) / ny
    b = GeometryBuilder()
    for j in range(ny):
        for i in range(nx):
            cx = xmin + (i + 0.5) * dx
            cy = ymin + (j + 0.5) * dy
            ang = np.sort(rng.uniform(0.0, 2 * np.pi, verts))
            rad = 0.62 + jitter * rng.uniform(-0.5, 0.5, verts)
            ring = np.column_stack(
                [cx + rad * dx * np.cos(ang), cy + rad * dy * np.sin(ang)]
            )
            b.add_geometry(GeometryType.POLYGON, [[ring]], srid=srid)
    return b.build()


def synthetic_raster(
    width: int,
    height: int,
    bbox: tuple[float, float, float, float] = NYC_BBOX,
    bands: int = 1,
    nodata: int = 32767,
    seed: int = 0,
):
    """A ``Raster`` of ``bands`` smooth int16 fields in ``[0, 32000]``
    whose north-up geotransform covers ``bbox``, with ``nodata`` on about
    a fifth of the pixels: an elliptical blob (~15%) plus speckle (~5%).
    A sensor-tile stand-in (reflectance-like values, a masked region, a
    nodata tag outside the value range)."""
    from .raster.core import Raster

    rng = np.random.default_rng(seed)
    xmin, ymin, xmax, ymax = bbox
    x = np.arange(width, dtype=np.float64)[None, :] / max(width, 1)
    y = np.arange(height, dtype=np.float64)[:, None] / max(height, 1)
    blob = ((x - 0.7) / 0.25) ** 2 + ((y - 0.3) / 0.2) ** 2 < 1.0
    out = np.empty((bands, height, width), dtype=np.int16)
    for b in range(bands):
        phase = rng.uniform(0, 2 * np.pi, 2)
        field = (
            16000.0
            + 9000.0 * np.sin(x * 9.0 + phase[0]) * np.cos(y * 7.0)
            + 6000.0 * np.cos((x + 2.0 * y) * 5.0 + phase[1])
        )
        band = np.clip(field, 0, 32000).astype(np.int16)
        band[blob | (rng.random((height, width)) < 0.05)] = nodata
        out[b] = band
    gt = (
        float(xmin), (xmax - xmin) / width, 0.0,
        float(ymax), 0.0, -(ymax - ymin) / height,
    )
    return Raster(data=out, gt=gt, srid=4326, nodata=float(nodata))


def random_points(
    n: int,
    bbox: tuple[float, float, float, float] = NYC_BBOX,
    seed: int = 0,
) -> np.ndarray:
    """(n, 2) float64 uniform points over ``bbox`` (pickup-point stand-in)."""
    rng = np.random.default_rng(seed)
    return np.column_stack(
        [rng.uniform(bbox[0], bbox[2], n), rng.uniform(bbox[1], bbox[3], n)]
    )
