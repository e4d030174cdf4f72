"""GML and GPX vector readers (stdlib XML, no GDAL).

Reference analog: the any-OGR-driver datasource reads GML and GPX through
GDAL (`datasource/OGRFileFormat.scala:26-473`); here the two formats are
parsed directly with ``xml.etree.ElementTree`` into the shared
:class:`~.vector.VectorTable`.

GML (2.1 ``coordinates`` and 3.x ``posList``/``pos`` forms): feature
members with Point / LineString / Polygon (exterior+interior) /
MultiPoint / MultiCurve / MultiSurface / MultiGeometry; non-geometry
child elements with text become attribute columns; ``srsName`` EPSG
codes are honored per geometry.

GPX 1.1: waypoints (``wpt``) as points, routes (``rte``) and track
segments (``trk``/``trkseg``) as linestrings, with name/ele/time
attributes. GPX is always WGS84 by spec.
"""

from __future__ import annotations

from xml.etree import ElementTree

import numpy as np

from ..core.crs import parse_crs_code
from ..core.types import GeometryBuilder, GeometryType, open_ring
from ._xml import find as _find, local as _local


def _srid_of(el, default: int) -> int:
    name = el.get("srsName")
    if not name:
        return default
    try:
        return parse_crs_code(name.rsplit(":", 1)[-1])
    except (ValueError, TypeError):
        return default


_GML_GEOMS = (
    "Point", "LineString", "LinearRing", "Polygon", "MultiPoint",
    "MultiCurve", "MultiSurface", "MultiGeometry", "MultiLineString",
    "MultiPolygon", "Curve", "Surface",
)


def _seg_coords(el, dim_hint: int) -> tuple[np.ndarray, np.ndarray | None]:
    """Coordinates of one posList/pos/coordinates carrier element."""
    pl = _find(el, "posList")
    if pl is not None:
        vals = np.asarray((pl.text or "").split(), dtype=np.float64)
        attr = pl.get("srsDimension", el.get("srsDimension"))
        if attr is not None:
            dim = int(attr)
        else:
            # real-world GML omits srsDimension on 3-D posLists; prefer a
            # dimension that actually divides the token count over blindly
            # assuming the hint. Token counts divisible by both 2 and 3
            # stay genuinely ambiguous — the hint wins those (a 3-D list
            # with an even point count still parses as 2-D).
            cands = [d for d in (dim_hint, 2, 3) if len(vals) % d == 0]
            if not cands:
                raise ValueError(
                    f"posList has {len(vals)} values, divisible by "
                    "neither 2 nor 3"
                )
            dim = cands[0]
        vals = vals.reshape(-1, dim)
        z = vals[:, 2].copy() if dim >= 3 else None
        return np.ascontiguousarray(vals[:, :2]), z
    pos = [c for c in el.iter() if _local(c.tag) == "pos"]
    if pos:
        rows = [np.asarray((p.text or "").split(), dtype=np.float64) for p in pos]
        dim = min(len(r) for r in rows)
        vals = np.stack([r[:dim] for r in rows])
        z = vals[:, 2].copy() if dim >= 3 else None
        return np.ascontiguousarray(vals[:, :2]), z
    co = _find(el, "coordinates")
    if co is not None:
        rows = [
            [float(v) for v in t.split(",") if v]
            for t in (co.text or "").split()
        ]
        if rows:
            dim = min(len(r) for r in rows)
            vals = np.asarray([r[:dim] for r in rows])
            z = vals[:, 2].copy() if dim >= 3 else None
            return np.ascontiguousarray(vals[:, :2]), z
    return np.zeros((0, 2)), None


def _gml_coords(el, dim_hint: int = 2) -> tuple[np.ndarray, np.ndarray | None]:
    """All coordinates of one GML geometry node. A multi-segment Curve
    concatenates its LineStringSegments (dropping each segment's repeated
    joint vertex); everything else is a single coordinate carrier."""
    segs = [c for c in el.iter() if _local(c.tag) == "LineStringSegment"]
    if segs:
        xs, zs, has_z = [], [], False
        for k, s in enumerate(segs):
            xy, z = _seg_coords(s, dim_hint)
            if k and xs and xy.shape[0] and np.array_equal(xs[-1][-1:], xy[:1]):
                xy = xy[1:]
                z = None if z is None else z[1:]
            if xy.shape[0]:
                xs.append(xy)
                zs.append(z)
                has_z = has_z or z is not None
        if not xs:
            return np.zeros((0, 2)), None
        xy = np.concatenate(xs)
        z = (
            np.concatenate([
                z if z is not None else np.full(x.shape[0], np.nan)
                for x, z in zip(xs, zs)
            ])
            if has_z
            else None
        )
        return xy, z
    return _seg_coords(el, dim_hint)


def _gml_rings(poly, dim_hint: int) -> list[tuple[np.ndarray, np.ndarray | None]]:
    """exterior ring then interiors (2.1 outer/innerBoundaryIs too)."""
    dim_hint = int(poly.get("srsDimension", dim_hint))
    rings = []
    for role in ("exterior", "outerBoundaryIs"):
        r = _find(poly, role)
        if r is not None:
            rings.append(open_ring(*_gml_coords(r, dim_hint)))
    for c in poly.iter():
        if _local(c.tag) in ("interior", "innerBoundaryIs"):
            rings.append(open_ring(*_gml_coords(c, dim_hint)))
    return rings


_POINTISH = ("Point",)
_LINEISH = ("LineString", "LinearRing", "Curve")
_POLYISH = ("Polygon", "Surface")


def _append_gml(b: GeometryBuilder, el, srid: int) -> "GeometryType | None":
    """Parse one GML geometry into ``b``; returns the appended type.

    Mixed-member MultiGeometry resolves with the first-polygonal
    collection rule the codecs share (`core/geometry/collection.py`)."""
    kind = _local(el.tag)
    srid = _srid_of(el, srid)
    dim = int(el.get("srsDimension", "2"))
    if kind in _POINTISH:
        xy, z = _gml_coords(el, dim)
        b.add_ring(xy[:1], None if z is None else z[:1])
        b.end_part()
        b.end_geom(GeometryType.POINT, srid)
        return GeometryType.POINT
    if kind in _LINEISH:
        b.add_ring(*_gml_coords(el, dim))
        b.end_part()
        b.end_geom(GeometryType.LINESTRING, srid)
        return GeometryType.LINESTRING
    if kind in _POLYISH:
        for xy, z in _gml_rings(el, dim):
            b.add_ring(xy, z)
        b.end_part()
        b.end_geom(GeometryType.POLYGON, srid)
        return GeometryType.POLYGON
    if kind == "MultiPoint":
        for m in el.iter():
            if _local(m.tag) == "Point":
                xy, z = _gml_coords(m, dim)
                b.add_ring(xy[:1], None if z is None else z[:1])
                b.end_part()
        b.end_geom(GeometryType.MULTIPOINT, srid)
        return GeometryType.MULTIPOINT
    if kind in ("MultiCurve", "MultiLineString"):
        for m in el.iter():
            if _local(m.tag) in ("LineString", "Curve"):
                b.add_ring(*_gml_coords(m, dim))
                b.end_part()
        b.end_geom(GeometryType.MULTILINESTRING, srid)
        return GeometryType.MULTILINESTRING
    if kind in ("MultiSurface", "MultiPolygon"):
        n = 0
        for m in el.iter():
            if _local(m.tag) == "Polygon":
                for xy, z in _gml_rings(m, dim):
                    b.add_ring(xy, z)
                b.end_part()
                n += 1
        if not n:
            b.end_part()
        b.end_geom(
            GeometryType.MULTIPOLYGON if n else GeometryType.POLYGON, srid
        )
        return GeometryType.MULTIPOLYGON
    if kind == "MultiGeometry":
        # members may mix types: parse each top-level member geometry and
        # resolve with the shared collection rule
        from ..core.geometry.collection import end_collection

        members = []
        for wrap in el:  # geometryMember wrappers or direct members
            cand = (
                wrap
                if _local(wrap.tag) in _GML_GEOMS
                else next(
                    (c for c in wrap if _local(c.tag) in _GML_GEOMS), None
                )
            )
            if cand is None:
                continue
            sub = GeometryBuilder()
            declared = _append_gml(sub, cand, srid)
            if declared is not None:
                members.append((declared, sub.build()))
        if not members:
            b.end_part()
            b.end_geom(GeometryType.GEOMETRYCOLLECTION, srid)
            return GeometryType.GEOMETRYCOLLECTION
        kinds = {d.base for d, _ in members}
        if len(kinds) == 1 and GeometryType.GEOMETRYCOLLECTION not in kinds:
            base = kinds.pop()
            for _, m in members:
                hz = m.has_z(0)
                for p in m.geom_parts(0):
                    for r in m.part_rings(p):
                        b.add_ring(
                            m.ring_xy(r), m.ring_z(r) if hz else None
                        )
                    b.end_part()
            b.end_geom(GeometryType(int(base) + 3), srid)
            return GeometryType(int(base) + 3)
        end_collection(b, members, srid)
        return GeometryType.GEOMETRYCOLLECTION
    return None


def read_gml(path, srid: int = 4326):
    """Parse a GML feature collection into a VectorTable."""
    from .vector import VectorTable

    root = ElementTree.parse(str(path)).getroot()
    b = GeometryBuilder()
    rows: list[dict[str, str]] = []
    members = [
        c
        for m in root.iter()
        if _local(m.tag) in ("featureMember", "featureMembers", "member")
        for c in m
    ] or [root]
    for feat in members:
        geom = None
        attrs: dict[str, str] = {}
        # a feature's properties are its direct children: one holds a GML
        # geometry descendant (the geometry column), text leaves are
        # attributes
        for prop in feat:
            ln = _local(prop.tag)
            if ln in _GML_GEOMS:
                geom = geom or prop
                continue
            g = next(
                (c for c in prop.iter() if _local(c.tag) in _GML_GEOMS),
                None,
            )
            if g is not None:
                geom = geom or g
            elif len(prop) == 0 and prop.text and prop.text.strip():
                attrs[ln] = prop.text.strip()
        if geom is not None and _append_gml(b, geom, srid) is not None:
            rows.append(attrs)
    col = b.build()
    keys = sorted({k for r in rows for k in r})
    return VectorTable(
        geometry=col,
        columns={
            k: np.asarray([r.get(k, "") for r in rows], dtype=object)
            for k in keys
        },
    )


# ------------------------------------------------------------------- GPX


def read_gpx(path):
    """Parse a GPX 1.1 file: wpt -> POINT, rte/trkseg -> LINESTRING."""
    from .vector import VectorTable

    root = ElementTree.parse(str(path)).getroot()
    b = GeometryBuilder()
    rows: list[dict[str, str]] = []

    def pt_of(el):
        return float(el.get("lon")), float(el.get("lat"))

    def attrs_of(el, kind):
        a = {"kind": kind}
        for c in el:
            if _local(c.tag) in ("name", "time", "ele", "desc") and c.text:
                a[_local(c.tag)] = c.text.strip()
        return a

    for el in root.iter():
        ln = _local(el.tag)
        if ln == "wpt":
            x, y = pt_of(el)
            ele = _find(el, "ele")
            z = (
                np.asarray([float(ele.text)])
                if ele is not None and ele.text
                else None
            )
            b.add_ring(np.asarray([[x, y]]), z)
            b.end_part()
            b.end_geom(GeometryType.POINT, 4326)
            rows.append(attrs_of(el, "wpt"))
        elif ln == "rte":
            xy = np.asarray(
                [pt_of(p) for p in el if _local(p.tag) == "rtept"]
            ).reshape(-1, 2)
            b.add_ring(xy, None)
            b.end_part()
            b.end_geom(GeometryType.LINESTRING, 4326)
            rows.append(attrs_of(el, "rte"))
        elif ln == "trk":
            # segments become rows carrying the enclosing track's
            # name/time attributes
            trk_attrs = attrs_of(el, "trkseg")
            for seg in el.iter():
                if _local(seg.tag) != "trkseg":
                    continue
                xy = np.asarray(
                    [pt_of(p) for p in seg if _local(p.tag) == "trkpt"]
                ).reshape(-1, 2)
                b.add_ring(xy, None)
                b.end_part()
                b.end_geom(GeometryType.LINESTRING, 4326)
                rows.append(dict(trk_attrs))
    col = b.build()
    keys = sorted({k for r in rows for k in r})
    return VectorTable(
        geometry=col,
        columns={
            k: np.asarray([r.get(k, "") for r in rows], dtype=object)
            for k in keys
        },
    )
