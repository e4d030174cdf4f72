"""TopoJSON vector reader (from scratch, to the public spec).

Reference analog: the OGR "TopoJSON" driver reachable through
``format("ogr").option("driverName", ...)`` (`datasource/OGRFileFormat.scala:
26-47` accepts any driver name). TopoJSON stores shared borders once as
*arcs*; geometries reference arcs by index (ones'-complement for reversed
traversal). Quantized topologies delta-encode arc vertices against a
``transform`` (scale + translate).

Decoding goes TopoJSON -> GeoJSON coordinate structures -> the shared
:func:`_append_geojson` packer, so every geometry type and the properties
contract behave exactly like the GeoJSON reader.
"""

from __future__ import annotations

import json

import numpy as np

from ..core.geometry.geojson import _append_geojson, _crs_srid
from ..core.types import GeometryBuilder


def _decode_arcs(topo: dict) -> list[np.ndarray]:
    """All arcs as absolute-coordinate float arrays [n, 2]."""
    tr = topo.get("transform")
    if tr:
        scale = np.asarray(tr.get("scale", [1.0, 1.0]), dtype=np.float64)
        shift = np.asarray(tr.get("translate", [0.0, 0.0]), dtype=np.float64)
    arcs = []
    for arc in topo.get("arcs", []):
        a = np.asarray(arc, dtype=np.float64).reshape(-1, 2)
        if tr:  # quantized: delta-encoded from the first position
            a = np.cumsum(a, axis=0) * scale + shift
        arcs.append(a)
    return arcs


def _point(topo: dict, pos) -> list:
    tr = topo.get("transform")
    p = list(map(float, pos))
    if tr:  # point positions are absolute quantized counts, not deltas
        sx, sy = tr.get("scale", [1.0, 1.0])
        tx, ty = tr.get("translate", [0.0, 0.0])
        p[0] = p[0] * sx + tx
        p[1] = p[1] * sy + ty
    return p


def _line(arcs: list[np.ndarray], idxs) -> list:
    """Stitch one arc chain into a coordinate list. A negative index ~i
    traverses arc i backwards; the shared junction point between
    consecutive arcs appears only once."""
    pts: list[list[float]] = []
    for k in idxs:
        a = arcs[~k][::-1] if k < 0 else arcs[k]
        seg = a.tolist()
        if pts:
            seg = seg[1:]
        pts.extend(seg)
    return pts


def _geometry(topo: dict, arcs: list[np.ndarray], obj: dict) -> dict | None:
    t = obj.get("type")
    if t is None:  # null geometry
        return None
    if t == "Point":
        return {"type": t, "coordinates": _point(topo, obj["coordinates"])}
    if t == "MultiPoint":
        return {
            "type": t,
            "coordinates": [_point(topo, p) for p in obj["coordinates"]],
        }
    if t == "LineString":
        return {"type": t, "coordinates": _line(arcs, obj["arcs"])}
    if t == "MultiLineString":
        return {
            "type": t,
            "coordinates": [_line(arcs, ix) for ix in obj["arcs"]],
        }
    if t == "Polygon":
        return {
            "type": t,
            "coordinates": [_line(arcs, ring) for ring in obj["arcs"]],
        }
    if t == "MultiPolygon":
        return {
            "type": t,
            "coordinates": [
                [_line(arcs, ring) for ring in poly] for poly in obj["arcs"]
            ],
        }
    if t == "GeometryCollection":
        return {
            "type": t,
            "geometries": [
                g
                for g in (
                    _geometry(topo, arcs, s)
                    for s in obj.get("geometries", [])
                )
                if g is not None
            ],
        }
    raise ValueError(f"unsupported TopoJSON geometry type: {t}")


def read_topojson(path_or_obj, layer: "str | None" = None):
    """TopoJSON Topology -> :class:`VectorTable`.

    One row per geometry object; the originating named object lands in a
    ``layer`` column (OGR maps each top-level object to a layer — passing
    ``layer=`` restricts to one, like OGR's layer selection).
    """
    from .vector import VectorTable

    if isinstance(path_or_obj, str) and not path_or_obj.lstrip().startswith("{"):
        with open(path_or_obj) as f:
            topo = json.load(f)
    elif isinstance(path_or_obj, str):
        topo = json.loads(path_or_obj)
    else:
        topo = path_or_obj
    if topo.get("type") != "Topology":
        raise ValueError("not a TopoJSON Topology document")
    objects = topo.get("objects", {})
    if layer is not None:
        if layer not in objects:
            raise ValueError(
                f"no such TopoJSON object {layer!r}; have {sorted(objects)}"
            )
        objects = {layer: objects[layer]}
    arcs = _decode_arcs(topo)
    srid = _crs_srid(topo)

    builder = GeometryBuilder()
    layers: list[str] = []
    props: list[dict] = []

    def emit(name: str, obj: dict) -> None:
        _append_geojson(builder, _geometry(topo, arcs, obj), srid)
        layers.append(name)
        props.append(obj.get("properties") or {})

    for name, obj in objects.items():
        # a top-level GeometryCollection is a layer: its members are the
        # features (OGR semantics); nested collections stay one geometry
        if obj.get("type") == "GeometryCollection":
            for sub in obj.get("geometries", []):
                emit(name, sub)
        else:
            emit(name, obj)

    from .vector import props_to_columns

    cols: dict[str, np.ndarray] = {
        "layer": np.asarray(layers, dtype=object)
    }
    cols.update(props_to_columns(props))
    return VectorTable(geometry=builder.build(), columns=cols)
