"""GeoJSON reader/writer to/from :class:`PackedGeometry`.

Port of ``mosaic_tpu/core/geometry/geojson.py``, line for line (a copy kept
in the port so that it never imports the JAX package).

Reference analog: `st_geomfromgeojson` / `st_asgeojson` and the JSONType
wrapper (`core/types/JSONType.scala:10-22`). GeoJSON coordinates are always
lon/lat (EPSG:4326) unless an (extended) ``crs`` member says otherwise.
"""

from __future__ import annotations

import json
from typing import Any, Sequence

import numpy as np

from ..types import GeometryBuilder, GeometryType, PackedGeometry, close_ring, open_ring


def _crs_srid(obj: dict) -> int:
    crs = obj.get("crs")
    if not crs:
        return 4326
    name = str(crs.get("properties", {}).get("name", ""))
    for tok in name.replace("::", ":").split(":"):
        if tok.isdigit():
            return int(tok)
    return 4326


def _rings_of(coords, drop_close: bool) -> list[tuple[np.ndarray, np.ndarray | None]]:
    out = []
    for ring in coords:
        a = np.asarray(ring, dtype=np.float64)
        if a.ndim == 1:
            a = a.reshape(1, -1)
        z = a[:, 2].copy() if a.shape[1] >= 3 else None
        xy = np.ascontiguousarray(a[:, :2])
        if drop_close:
            xy, z = open_ring(xy, z)
        out.append((xy, z))
    return out


def _append_geojson(builder: GeometryBuilder, obj: dict | None, srid: int) -> None:
    if obj is None:  # GeoJSON allows Features with null geometry
        builder.end_part()
        builder.end_geom(GeometryType.GEOMETRYCOLLECTION, srid)
        return
    gtype = GeometryType.from_name(obj["type"])
    coords = obj.get("coordinates", [])
    if gtype == GeometryType.POINT:
        for xy, z in _rings_of([coords], drop_close=False):
            builder.add_ring(xy, z)
        builder.end_part()
    elif gtype == GeometryType.LINESTRING:
        for xy, z in _rings_of([coords], drop_close=False):
            builder.add_ring(xy, z)
        builder.end_part()
    elif gtype == GeometryType.POLYGON:
        for xy, z in _rings_of(coords, drop_close=True):
            builder.add_ring(xy, z)
        builder.end_part()
    elif gtype == GeometryType.MULTIPOINT:
        for xy, z in _rings_of([[c] for c in coords], drop_close=False):
            builder.add_ring(xy, z)
            builder.end_part()
    elif gtype == GeometryType.MULTILINESTRING:
        for xy, z in _rings_of(coords, drop_close=False):
            builder.add_ring(xy, z)
            builder.end_part()
    elif gtype == GeometryType.MULTIPOLYGON:
        for poly in coords:
            for xy, z in _rings_of(poly, drop_close=True):
                builder.add_ring(xy, z)
            builder.end_part()
    elif gtype == GeometryType.GEOMETRYCOLLECTION:
        subs = obj.get("geometries", [])
        if subs:  # reference first-polygonal semantics
            from .collection import end_collection

            members = []
            for sobj in subs:
                sub = GeometryBuilder()
                _append_geojson(sub, sobj, srid)
                members.append(
                    (GeometryType.from_name(sobj["type"]), sub.build())
                )
            end_collection(builder, members, srid)
            return
        builder.end_part()  # empty collection: keep the GC type
    builder.end_geom(gtype, srid)


def from_geojson(docs: Sequence[str | dict] | str | dict) -> PackedGeometry:
    if isinstance(docs, (str, dict)):
        docs = [docs]
    builder = GeometryBuilder()
    for d in docs:
        obj = json.loads(d) if isinstance(d, str) else d
        srid = _crs_srid(obj) if isinstance(obj, dict) else 4326
        _append_geojson(builder, obj, srid)
    return builder.build()


def _coords_json(xy: np.ndarray, z: np.ndarray | None, close: bool) -> list:
    pts, zz = (close_ring(xy, z) if close else (xy, z))
    if zz is not None:
        return [[float(p[0]), float(p[1]), float(w)] for p, w in zip(pts, zz)]
    return [[float(p[0]), float(p[1])] for p in pts]


def to_geojson_obj(col: PackedGeometry) -> list[dict[str, Any]]:
    out = []
    for g in range(len(col)):
        gt = col.geometry_type(g)
        parts = list(col.geom_parts(g))
        hz = col.has_z(g)

        def ring_z(r):
            return col.ring_z(r) if hz else None

        def part_rings_json(p, close):
            return [
                _coords_json(col.ring_xy(r), ring_z(r), close)
                for r in col.part_rings(p)
            ]

        if gt == GeometryType.GEOMETRYCOLLECTION:
            # only empties are representable (null-geometry features)
            obj = {"type": "GeometryCollection", "geometries": []}
        elif gt == GeometryType.POINT:
            rings = [r for p in parts for r in col.part_rings(p)]
            c = (
                _coords_json(col.ring_xy(rings[0]), ring_z(rings[0]), False)[0]
                if rings and col.ring_xy(rings[0]).shape[0]
                else []
            )
            obj = {"type": "Point", "coordinates": c}
        elif gt == GeometryType.LINESTRING:
            rings = [r for p in parts for r in col.part_rings(p)]
            obj = {
                "type": "LineString",
                "coordinates": _coords_json(col.ring_xy(rings[0]), ring_z(rings[0]), False)
                if rings
                else [],
            }
        elif gt == GeometryType.POLYGON:
            obj = {
                "type": "Polygon",
                "coordinates": part_rings_json(parts[0], True) if parts else [],
            }
        elif gt == GeometryType.MULTIPOINT:
            cs = []
            for p in parts:
                for r in col.part_rings(p):
                    cs.append(_coords_json(col.ring_xy(r), ring_z(r), False)[0])
            obj = {"type": "MultiPoint", "coordinates": cs}
        elif gt == GeometryType.MULTILINESTRING:
            cs = []
            for p in parts:
                for r in col.part_rings(p):
                    cs.append(_coords_json(col.ring_xy(r), ring_z(r), False))
            obj = {"type": "MultiLineString", "coordinates": cs}
        elif gt == GeometryType.MULTIPOLYGON:
            obj = {
                "type": "MultiPolygon",
                "coordinates": [part_rings_json(p, True) for p in parts],
            }
        else:
            raise NotImplementedError(gt)
        srid = int(col.srid[g])
        if srid and srid != 4326:
            obj["crs"] = {"type": "name", "properties": {"name": f"EPSG:{srid}"}}
        out.append(obj)
    return out


def to_geojson(col: PackedGeometry) -> list[str]:
    return [json.dumps(o) for o in to_geojson_obj(col)]


def read_feature_collection(path_or_obj) -> tuple[PackedGeometry, "list[dict]"]:
    """Load a GeoJSON FeatureCollection -> (geometry column, properties list).

    This is the framework's analog of reading vector files through OGR
    (`datasource/OGRFileFormat.scala:441-473`): geometry lands in packed
    arrays, properties in a list of dicts (convertible to a DataFrame).
    """
    if isinstance(path_or_obj, (str,)):
        with open(path_or_obj) as f:
            text = f.read()
        try:
            obj = json.loads(text)
        except json.JSONDecodeError:
            # newline-delimited GeoJSON (GeoJSONSeq / NDJSON): one feature
            # per line — e.g. the reference's NYC_Taxi_Zones.geojson fixture
            obj = {
                "type": "FeatureCollection",
                "features": [
                    # RFC 8142 GeoJSON text sequences prefix records with
                    # RS (0x1e) — strip it so OGR GeoJSONSeq files load
                    json.loads(line.lstrip("\x1e"))
                    for line in text.splitlines()
                    if line.strip("\x1e").strip()
                ],
            }
    else:
        obj = path_or_obj
    feats = obj["features"] if obj.get("type") == "FeatureCollection" else [obj]
    builder = GeometryBuilder()
    props = []
    srid = _crs_srid(obj)
    for f in feats:
        _append_geojson(builder, f.get("geometry"), srid)
        props.append(f.get("properties", {}))
    return builder.build(), props
