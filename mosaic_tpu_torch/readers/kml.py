"""KML vector reader (stdlib XML, no GDAL).

Reference analog: the any-OGR-driver datasource reads KML through GDAL's
LIBKML driver (`datasource/OGRFileFormat.scala:26-473`, driver picked by
extension); here OGC KML 2.2 is parsed directly with
``xml.etree.ElementTree`` into the same :class:`VectorTable` the other
vector readers produce. Handled: ``Document``/``Folder`` nesting,
``Placemark`` with Point / LineString / LinearRing / Polygon
(outer+inner boundaries) / MultiGeometry, 2D/3D ``coordinates`` tuples,
``name`` and ``ExtendedData`` (both ``Data/value`` and
``SchemaData/SimpleData`` forms) as attribute columns. KML coordinates
are always lon/lat WGS84 (EPSG:4326) by spec.
"""

from __future__ import annotations

from xml.etree import ElementTree

import numpy as np

from ..core.types import GeometryBuilder, GeometryType, open_ring
from ._xml import children as _children, find as _find, local as _local


def _coords(el) -> tuple[np.ndarray, np.ndarray | None]:
    """Parse a <coordinates> text block: 'lon,lat[,alt]' whitespace-
    separated tuples."""
    text = (el.text or "").strip()
    if not text:
        return np.zeros((0, 2)), None
    # drop empty tokens: trailing commas ("lon,lat,") are common in
    # hand-written KML and must not count as a dimension
    rows = [[v for v in t.split(",") if v] for t in text.split()]
    dims = min(len(r) for r in rows)
    vals = np.asarray(
        [[float(v) for v in r[:dims]] for r in rows], dtype=np.float64
    )
    z = vals[:, 2].copy() if dims >= 3 else None
    return np.ascontiguousarray(vals[:, :2]), z


def _append_geometry(b: GeometryBuilder, el) -> "GeometryType | None":
    """Parse one KML geometry element into ``b``.

    Returns the DECLARED type (the role the element plays in collection
    resolution): a mixed-member MultiGeometry reports
    GEOMETRYCOLLECTION even though its content coerces, so an enclosing
    MultiGeometry's first-polygonal rule never selects it — the same
    nested-collection contract as the WKT/WKB/GeoJSON codecs.
    """
    kind = _local(el.tag)
    if kind == "Point":
        c = _find(el, "coordinates")
        xy, z = _coords(c) if c is not None else (np.zeros((0, 2)), None)
        b.add_ring(xy[:1], None if z is None else z[:1])
        b.end_part()
        b.end_geom(GeometryType.POINT, 4326)
        return GeometryType.POINT
    if kind in ("LineString", "LinearRing"):
        c = _find(el, "coordinates")
        xy, z = _coords(c) if c is not None else (np.zeros((0, 2)), None)
        b.add_ring(xy, z)
        b.end_part()
        b.end_geom(GeometryType.LINESTRING, 4326)
        return GeometryType.LINESTRING
    if kind == "Polygon":
        for boundary in ("outerBoundaryIs", "innerBoundaryIs"):
            for bnd in _children(el, boundary):
                ring = _find(bnd, "coordinates")
                if ring is None:
                    continue
                xy, z = open_ring(*_coords(ring))
                b.add_ring(xy, z)
        b.end_part()
        b.end_geom(GeometryType.POLYGON, 4326)
        return GeometryType.POLYGON
    if kind == "MultiGeometry":
        # homogeneous members collapse to the matching MULTI type; mixed
        # members resolve with the collection rule the codecs share
        members: list[tuple[GeometryType, object]] = []
        kinds: set[str] = set()
        for g_el in el:
            if not _is_geometry_tag(g_el):
                continue
            sub = GeometryBuilder()
            declared = _append_geometry(sub, g_el)
            members.append((declared, sub.build()))
            kinds.add(_local(g_el.tag))
        if not members:
            b.end_part()
            b.end_geom(GeometryType.GEOMETRYCOLLECTION, 4326)
            return GeometryType.GEOMETRYCOLLECTION
        if kinds <= {"Point"}:
            gt = GeometryType.MULTIPOINT
        elif kinds <= {"LineString", "LinearRing"}:
            gt = GeometryType.MULTILINESTRING
        elif kinds <= {"Polygon"}:
            gt = GeometryType.MULTIPOLYGON
        else:
            from ..core.geometry.collection import end_collection

            end_collection(b, members, 4326)
            return GeometryType.GEOMETRYCOLLECTION
        # copy every member's rings as parts of one multi-geometry
        for _, m in members:
            hz = m.has_z(0)
            for p in m.geom_parts(0):
                for r in m.part_rings(p):
                    b.add_ring(m.ring_xy(r), m.ring_z(r) if hz else None)
                b.end_part()
        b.end_geom(gt, 4326)
        return gt
    return None


def _is_geometry_tag(el) -> bool:
    return _local(el.tag) in (
        "Point", "LineString", "LinearRing", "Polygon", "MultiGeometry"
    )


def _placemark_attrs(pm) -> dict[str, str]:
    attrs: dict[str, str] = {}
    for c in pm:
        if _local(c.tag) == "name":
            attrs["name"] = (c.text or "").strip()
        elif _local(c.tag) == "ExtendedData":
            for d in c.iter():
                ln = _local(d.tag)
                if ln == "Data":
                    v = _find(d, "value")
                    attrs[d.get("name", "")] = (
                        (v.text or "").strip() if v is not None else ""
                    )
                elif ln == "SimpleData":
                    attrs[d.get("name", "")] = (d.text or "").strip()
    attrs.pop("", None)
    return attrs


def read_kml(path):
    """Parse a KML file into a :class:`~.vector.VectorTable`."""
    from .vector import VectorTable

    root = ElementTree.parse(str(path)).getroot()
    b = GeometryBuilder()
    rows: list[dict[str, str]] = []
    for pm in root.iter():
        if _local(pm.tag) != "Placemark":
            continue
        geom = next((g for g in pm if _is_geometry_tag(g)), None)
        if geom is None:
            continue
        if _append_geometry(b, geom) is not None:
            rows.append(_placemark_attrs(pm))
    col = b.build()
    keys = sorted({k for r in rows for k in r})
    columns = {
        k: np.asarray([r.get(k, "") for r in rows], dtype=object)
        for k in keys
    }
    return VectorTable(geometry=col, columns=columns)


def write_kml(path: str, table, name_col: "str | None" = None) -> None:
    """Write a VectorTable as KML Placemarks (round-trips through
    :func:`read_kml`): Point / LineString / Polygon (outer+inner
    boundaries) / MultiGeometry, attributes as ExtendedData/Data values.

    Reference analog: OGR's KML driver write side
    (`datasource/OGRFileFormat.scala:26-47` names the driver family)."""
    import numpy as np

    from ..core.types import GeometryType

    col = table.geometry

    def coords(xy):
        return " ".join(
            f"{float(x)!r},{float(y)!r}" for x, y in np.asarray(xy)
        )

    def polygon(rings):
        out = ["<Polygon>"]
        for k, r in enumerate(rings):
            r = np.asarray(r)
            if r.shape[0] and not np.array_equal(r[0], r[-1]):
                r = np.concatenate([r, r[:1]])
            tag = "outerBoundaryIs" if k == 0 else "innerBoundaryIs"
            out.append(
                f"<{tag}><LinearRing><coordinates>{coords(r)}"
                f"</coordinates></LinearRing></{tag}>"
            )
        out.append("</Polygon>")
        return "".join(out)

    def geometry(g):
        gt = col.geometry_type(g)
        base = gt.base
        if base == GeometryType.POINT and gt == GeometryType.MULTIPOINT:
            pts = np.asarray(col.geom_xy(g))
            return (
                "<MultiGeometry>"
                + "".join(
                    f"<Point><coordinates>{coords(p[None])}"
                    "</coordinates></Point>"
                    for p in pts
                )
                + "</MultiGeometry>"
            )
        if base == GeometryType.POINT:
            return (
                f"<Point><coordinates>{coords(col.geom_xy(g))}"
                "</coordinates></Point>"
            )
        if base == GeometryType.LINESTRING:
            parts = [
                f"<LineString><coordinates>{coords(col.ring_xy(r))}"
                "</coordinates></LineString>"
                for p in col.geom_parts(g)
                for r in col.part_rings(p)
            ]
            if len(parts) == 1:
                return parts[0]
            return "<MultiGeometry>" + "".join(parts) + "</MultiGeometry>"
        # polygons: one <Polygon> per part (shell + holes)
        polys = [
            polygon([col.ring_xy(r) for r in col.part_rings(p)])
            for p in col.geom_parts(g)
        ]
        if len(polys) == 1:
            return polys[0]
        return "<MultiGeometry>" + "".join(polys) + "</MultiGeometry>"

    def esc(s):
        return (
            str(s)
            .replace("&", "&amp;")
            .replace("<", "&lt;")
            .replace(">", "&gt;")
        )

    def esc_attr(s):
        # attribute values additionally need quote escaping (the
        # xml.sax.saxutils.quoteattr contract): a column name carrying
        # '"' would otherwise terminate the name="..." attribute early
        return esc(s).replace('"', "&quot;").replace("'", "&apos;")

    rows = []
    for g in range(len(col)):
        nm = (
            f"<name>{esc(table.columns[name_col][g])}</name>"
            if name_col and name_col in table.columns
            else ""
        )
        data = "".join(
            f'<Data name="{esc_attr(k)}"><value>{esc(v[g])}</value></Data>'
            for k, v in table.columns.items()
            if k != name_col
        )
        ext = f"<ExtendedData>{data}</ExtendedData>" if data else ""
        rows.append(f"<Placemark>{nm}{ext}{geometry(g)}</Placemark>")
    doc = (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<kml xmlns="http://www.opengis.net/kml/2.2"><Document>'
        + "".join(rows)
        + "</Document></kml>"
    )
    with open(path, "w") as f:
        f.write(doc)
