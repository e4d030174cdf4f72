"""OpenStreetMap XML (.osm) reader -> VectorTable.

Reference analog: OGR's OSM driver behind `OGRFileFormat`
(`datasource/OGRFileFormat.scala:26-47` accepts any driver name). OGR
splits OSM into per-type layers; this columnar reader keeps one table
with a ``kind`` column instead (point / line / polygon / multipolygon),
which filters to the same subsets.

Feature rules (OGR-compatible in spirit):
- tagged nodes -> POINT features;
- ways -> LINESTRING, or POLYGON when the way is closed and carries an
  area-ish tag (``area=yes``, ``building``, ``landuse``, ``natural``,
  ``leisure``, ``amenity`` ...) — highways stay lines even when closed
  (roundabouts);
- ``type=multipolygon``/``boundary`` relations -> (MULTI)POLYGON from
  their outer/inner member ways (members missing from the extract are
  skipped, like OGR's incomplete-relation handling).

Tags land as object columns via the shared ``props_to_columns`` typing;
``osm_id`` and ``kind`` are always present.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from ..core.types import GeometryBuilder, GeometryType
from .vector import VectorTable, props_to_columns

#: closed ways with any of these tag keys become polygons
_AREA_KEYS = {
    "building", "landuse", "natural", "leisure", "amenity", "area",
    "shop", "tourism", "waterway", "place",
}


def _is_area(tags: dict) -> bool:
    if tags.get("area") == "no":
        return False
    if tags.get("area") == "yes":
        return True
    if "highway" in tags or "barrier" in tags:
        return False
    return any(k in tags for k in _AREA_KEYS)


def _ring_from_way_refs(refs, nodes) -> "np.ndarray | None":
    pts = [nodes[r] for r in refs if r in nodes]
    if len(pts) < 2 or len(pts) != len(refs):
        return None
    return np.asarray(pts, dtype=np.float64)


def _assemble_rings(ways: "list[np.ndarray]") -> "list[np.ndarray]":
    """Chain open member ways into closed rings (endpoint matching)."""
    segs = [w for w in ways if w is not None and w.shape[0] >= 2]
    rings: list[np.ndarray] = []
    while segs:
        cur = segs.pop()
        # already closed?
        while not np.array_equal(cur[0], cur[-1]):
            for i, s in enumerate(segs):
                if np.array_equal(s[0], cur[-1]):
                    cur = np.concatenate([cur, s[1:]])
                    segs.pop(i)
                    break
                if np.array_equal(s[-1], cur[-1]):
                    cur = np.concatenate([cur, s[::-1][1:]])
                    segs.pop(i)
                    break
            else:
                cur = None  # incomplete ring: drop (OGR skips too)
                break
        if cur is not None and cur.shape[0] >= 4:
            rings.append(cur)
    return rings


def read_osm(path: str) -> VectorTable:
    """Parse an OSM XML extract into a single VectorTable."""
    nodes: dict[str, tuple[float, float]] = {}
    node_tags: dict[str, dict] = {}
    ways: dict[str, list] = {}
    way_tags: dict[str, dict] = {}
    relations: list[tuple[str, dict, list]] = []

    for _ev, el in ET.iterparse(path, events=("end",)):
        if el.tag == "node":
            nid = el.get("id")
            nodes[nid] = (float(el.get("lon")), float(el.get("lat")))
            tags = {t.get("k"): t.get("v") for t in el.findall("tag")}
            if tags:
                node_tags[nid] = tags
            el.clear()
        elif el.tag == "way":
            wid = el.get("id")
            ways[wid] = [nd.get("ref") for nd in el.findall("nd")]
            way_tags[wid] = {
                t.get("k"): t.get("v") for t in el.findall("tag")
            }
            el.clear()
        elif el.tag == "relation":
            tags = {t.get("k"): t.get("v") for t in el.findall("tag")}
            members = [
                (m.get("type"), m.get("ref"), m.get("role") or "outer")
                for m in el.findall("member")
            ]
            relations.append((el.get("id"), tags, members))
            el.clear()

    b = GeometryBuilder()
    props: list[dict] = []

    def emit(gtype, parts, osm_id, kind, tags):
        b.add_geometry(gtype, parts, 4326)
        props.append({"osm_id": osm_id, "kind": kind, **tags})

    for nid, tags in node_tags.items():
        xy = np.asarray([nodes[nid]], dtype=np.float64)
        emit(GeometryType.POINT, [[xy]], nid, "point", tags)

    ways_in_relations: set[str] = set()
    for _rid, tags, members in relations:
        if tags.get("type") in ("multipolygon", "boundary"):
            for mtype, ref, _role in members:
                if mtype == "way":
                    ways_in_relations.add(ref)

    for wid, refs in ways.items():
        tags = way_tags.get(wid, {})
        if not tags and wid in ways_in_relations:
            continue  # pure relation-member way: geometry only
        ring = _ring_from_way_refs(refs, nodes)
        if ring is None:
            continue
        closed = ring.shape[0] >= 4 and np.array_equal(ring[0], ring[-1])
        if closed and _is_area(tags):
            emit(GeometryType.POLYGON, [[ring[:-1]]], wid, "polygon", tags)
        else:
            emit(GeometryType.LINESTRING, [[ring]], wid, "line", tags)

    for rid, tags, members in relations:
        if tags.get("type") not in ("multipolygon", "boundary"):
            continue
        outers = _assemble_rings(
            [
                _ring_from_way_refs(ways.get(ref, []), nodes)
                for mtype, ref, role in members
                if mtype == "way" and role in ("outer", "")
            ]
        )
        inners = _assemble_rings(
            [
                _ring_from_way_refs(ways.get(ref, []), nodes)
                for mtype, ref, role in members
                if mtype == "way" and role == "inner"
            ]
        )
        if not outers:
            continue
        if len(outers) == 1:
            rings = [outers[0][:-1]] + [r[:-1] for r in inners]
            emit(GeometryType.POLYGON, [rings], rid, "multipolygon", tags)
        else:
            # holes attach to the first outer that bbox-contains them
            polys = [[o[:-1]] for o in outers]
            for hole in inners:
                hb = hole.min(0), hole.max(0)
                for poly in polys:
                    ob = poly[0].min(0), poly[0].max(0)
                    if (ob[0] <= hb[0]).all() and (hb[1] <= ob[1]).all():
                        poly.append(hole[:-1])
                        break
            emit(GeometryType.MULTIPOLYGON, polys, rid, "multipolygon", tags)

    if not props:
        raise ValueError(f"no features found in {path}")
    cols = props_to_columns(props)
    # osm ids are numeric strings: keep them int64 for joins
    cols["osm_id"] = np.asarray(
        [int(p["osm_id"]) for p in props], dtype=np.int64
    )
    return VectorTable(geometry=b.build(), columns=cols)
