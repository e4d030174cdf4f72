"""GeometryCollection handling shared by the WKT/WKB/GeoJSON codecs.

Port of ``mosaic_tpu/core/geometry/collection.py``, line for line (a copy kept
in the port so that it never imports the JAX package).

Reference semantics (`core/geometry/MosaicGeometryJTS.scala:179-192`, the
"hotfix for intersections that generate a geometry collection"):
constructing a geometry from a non-empty GEOMETRYCOLLECTION keeps the
FIRST polygonal top-level member (a POLYGON or MULTIPOLYGON, as-is) and
discards everything else; a collection with no polygonal member becomes
POLYGON EMPTY. Nested collections are not searched — the reference's
``find`` inspects only top-level member types. Explicitly EMPTY
collections keep their GEOMETRYCOLLECTION type (the codecs use it for
null-geometry features), a representable superset of the reference,
which collapses those to POLYGON EMPTY too.
"""

from __future__ import annotations

from ..types import GeometryBuilder, GeometryType, PackedGeometry

_POLYGONAL = (GeometryType.POLYGON, GeometryType.MULTIPOLYGON)


def end_collection(
    builder: GeometryBuilder,
    members: list[tuple[GeometryType, PackedGeometry]],
    srid: int,
) -> None:
    """Resolve a parsed collection with the reference's semantics.

    ``members`` pairs each top-level member's DECLARED type (a nested
    collection stays GEOMETRYCOLLECTION here even though its own parse
    already coerced it) with its single-geometry parse result. The kept
    member carries its own SRID (e.g. an EWKB member flag), so the copy
    preserves it over the collection-level default.
    """
    for declared, col in members:
        if declared in _POLYGONAL:
            builder.append_from(col, 0)
            return
    builder.end_part()
    builder.end_geom(GeometryType.POLYGON, srid)
