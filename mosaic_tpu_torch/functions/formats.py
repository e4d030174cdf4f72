"""Format conversions + geometry constructors.

Port of ``mosaic_tpu/functions/formats.py`` (host numpy, as in the reference).

Reference analog: `expressions/format/ConvertTo.scala:24-147` (any-to-any
geometry format casts registered as `convert_to_*`/`as_hex`/`as_json`,
`st_aswkt`/`st_aswkb`/... aliases) and the constructor expressions
`ST_Point`/`ST_MakeLine`/`ST_MakePolygon` (`expressions/constructors/`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.types import GeometryBuilder, GeometryType, PackedGeometry
from ._coerce import serialize, to_packed

__all__ = [
    "convert_to", "convert_to_wkt", "convert_to_wkb", "convert_to_hex",
    "convert_to_geojson", "convert_to_coords", "as_hex", "as_json",
    "st_astext", "st_aswkt", "st_asbinary", "st_aswkb", "st_asgeojson",
    "st_geomfromwkt", "st_geomfromwkb", "st_geomfromgeojson",
    "st_point", "st_makeline", "st_makepolygon", "st_polygon",
]


def convert_to(geom, fmt: str):
    """Any geometry input -> the named format (reference: ConvertTo)."""
    fmt = fmt.strip().lower()
    aliases = {
        "jsonobject": "geojson",
        "json": "geojson",
        "coords": "packed",
        "internal": "packed",
    }
    return serialize(to_packed(geom), aliases.get(fmt, fmt))


def convert_to_wkt(geom):
    return convert_to(geom, "wkt")


def convert_to_wkb(geom):
    return convert_to(geom, "wkb")


def convert_to_hex(geom):
    return convert_to(geom, "hex")


def convert_to_geojson(geom):
    return convert_to(geom, "geojson")


def convert_to_coords(geom) -> PackedGeometry:
    return to_packed(geom)


as_hex = convert_to_hex
as_json = convert_to_geojson
st_astext = convert_to_wkt
st_aswkt = convert_to_wkt
st_asbinary = convert_to_wkb
st_aswkb = convert_to_wkb
st_asgeojson = convert_to_geojson


def st_geomfromwkt(wkts, srid: int = 4326) -> PackedGeometry:
    from ..core.geometry.wkt import from_wkt

    return from_wkt(wkts, srid=srid)


def st_geomfromwkb(blobs, srid: int = 4326) -> PackedGeometry:
    from ..core.geometry.wkb import from_hex, from_wkb

    first = blobs[0] if isinstance(blobs, (list, tuple)) else blobs
    if isinstance(first, str):
        return from_hex(blobs, srid=srid)
    return from_wkb(blobs, srid=srid)


def st_geomfromgeojson(docs) -> PackedGeometry:
    from ..core.geometry.geojson import from_geojson

    return from_geojson(docs)


# ------------------------------------------------------------ constructors


def st_point(x, y, srid: int = 4326) -> PackedGeometry:
    """Column of POINTs from coordinate arrays (reference: ST_Point)."""
    xa = np.atleast_1d(np.asarray(x, dtype=np.float64))
    ya = np.atleast_1d(np.asarray(y, dtype=np.float64))
    b = GeometryBuilder()
    for i in range(xa.shape[0]):
        b.add_geometry(
            GeometryType.POINT, [[np.array([[xa[i], ya[i]]])]], srid
        )
    return b.build()


def st_makeline(points_per_row: Sequence, srid: int = 4326) -> PackedGeometry:
    """Each row: a sequence of points (as (N,2) array or POINT column) ->
    LINESTRING (reference: ST_MakeLine)."""
    b = GeometryBuilder()
    for row in points_per_row:
        if isinstance(row, PackedGeometry):
            xy = np.concatenate(
                [row.geom_xy(g) for g in range(len(row))], axis=0
            )
        else:
            xy = np.asarray(row, dtype=np.float64).reshape(-1, 2)
        b.add_geometry(GeometryType.LINESTRING, [[xy]], srid)
    return b.build()


def st_makepolygon(boundary, holes: Sequence | None = None) -> PackedGeometry:
    """LINESTRING ring column (+ optional per-row hole lists) -> POLYGON
    (reference: ST_MakePolygon)."""
    col = to_packed(boundary)
    b = GeometryBuilder()
    for g in range(len(col)):
        rings = [col.geom_xy(g)]
        if holes is not None and holes[g] is not None:
            for h in holes[g]:
                rings.append(np.asarray(h, dtype=np.float64).reshape(-1, 2))
        b.add_geometry(GeometryType.POLYGON, [rings], int(col.srid[g]))
    return b.build()


st_polygon = st_makepolygon
