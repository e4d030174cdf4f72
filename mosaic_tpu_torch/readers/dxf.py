"""AutoCAD DXF (ASCII) entity reader.

Reference analog: another slice of `OGRFileFormat`'s any-driver breadth
(`datasource/OGRFileFormat.scala:26-47` — OGR ships a DXF driver); CAD
site plans routinely arrive as DXF in geospatial pipelines.

Reads the ENTITIES section's 2-D geometry, mapping like OGR's driver:
POINT → POINT, LINE → LINESTRING, LWPOLYLINE / POLYLINE+VERTEX →
LINESTRING (closed flag 70 bit 1 → POLYGON), CIRCLE → POLYGON
(64-gon, OGR's tessellated analog). Each entity carries its layer
(code 8) as the ``layer`` column. 3-D codes (30/38) are ignored —
the column contract is 2-D like every other reader here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.types import GeometryBuilder, GeometryType
from .vector import VectorTable


def _pairs(path: Path):
    """DXF is (group-code, value) line pairs."""
    lines = path.read_text(errors="replace").splitlines()
    for k in range(0, len(lines) - 1, 2):
        try:
            yield int(lines[k].strip()), lines[k + 1].strip()
        except ValueError:
            continue


def read_dxf(path: str) -> VectorTable:
    """Read `path` (.dxf) into a VectorTable with a ``layer`` column."""
    b = GeometryBuilder()
    layers: list[str] = []

    in_entities = False
    ent: str | None = None
    layer = ""
    data: dict[int, list[float]] = {}
    poly_pts: list[list[float]] = []  # POLYLINE ... VERTEX ... SEQEND
    poly_closed = False
    poly_layer = ""
    in_poly = False

    def emit(kind: str, lay: str, d: dict[int, list[float]]):
        # incomplete entities (missing paired codes) are skipped, not
        # fatal — a truncated CAD export should not lose the whole file
        xs, ys = d.get(10, []), d.get(20, [])
        if kind == "POINT" and xs and ys:
            b.add_geometry(
                GeometryType.POINT, [[np.asarray([[xs[0], ys[0]]])]], 0
            )
            layers.append(lay)
        elif kind == "LINE" and xs and ys and d.get(11) and d.get(21):
            xy = np.asarray(
                [[xs[0], ys[0]], [d[11][0], d[21][0]]]
            )
            b.add_geometry(GeometryType.LINESTRING, [[xy]], 0)
            layers.append(lay)
        elif kind == "LWPOLYLINE" and min(len(xs), len(ys)) >= 2:
            k = min(len(xs), len(ys))
            xy = np.stack([xs[:k], ys[:k]], axis=-1)
            closed = int(d.get(70, [0])[0]) & 1
            if closed and k >= 3:
                b.add_geometry(GeometryType.POLYGON, [[xy]], 0)
            else:
                b.add_geometry(GeometryType.LINESTRING, [[xy]], 0)
            layers.append(lay)
        elif kind == "CIRCLE" and xs and ys and d.get(40):
            t = np.linspace(0.0, 2 * np.pi, 65)[:-1]
            xy = np.stack(
                [xs[0] + d[40][0] * np.cos(t), ys[0] + d[40][0] * np.sin(t)],
                axis=-1,
            )
            b.add_geometry(GeometryType.POLYGON, [[xy]], 0)
            layers.append(lay)

    for code, val in _pairs(Path(path)):
        if code == 0:
            # close out the pending simple entity
            if ent in ("POINT", "LINE", "LWPOLYLINE", "CIRCLE") and in_entities:
                emit(ent, layer, data)
            if val == "SECTION":
                ent = "SECTION"
            elif val == "ENDSEC":
                in_entities = False
                ent = None
            elif val == "EOF":
                break
            elif in_entities:
                if val == "POLYLINE":
                    in_poly = True
                    poly_pts = []
                    poly_closed = False
                    poly_layer = ""
                    ent = "POLYLINE"
                elif val == "VERTEX" and in_poly:
                    ent = "VERTEX"
                elif val == "SEQEND" and in_poly:
                    if len(poly_pts) >= 2:
                        xy = np.asarray(poly_pts)
                        if poly_closed and len(poly_pts) >= 3:
                            b.add_geometry(GeometryType.POLYGON, [[xy]], 0)
                        else:
                            b.add_geometry(
                                GeometryType.LINESTRING, [[xy]], 0
                            )
                        layers.append(poly_layer)
                    in_poly = False
                    ent = None
                else:
                    ent = val
            data = {}
            layer = ""
            continue
        if ent == "SECTION" and code == 2:
            in_entities = val.upper() == "ENTITIES"
        elif in_entities:
            if code == 8:
                if ent == "POLYLINE":
                    poly_layer = val
                else:
                    layer = val
            elif code == 70 and ent == "POLYLINE":
                poly_closed = bool(int(val) & 1)
            elif code in (10, 20, 11, 21, 40, 70):
                try:
                    v = float(val)
                except ValueError:
                    continue
                if ent == "VERTEX" and code in (10, 20):
                    if code == 10:
                        poly_pts.append([v, 0.0])
                    elif poly_pts:
                        poly_pts[-1][1] = v
                else:
                    data.setdefault(code, []).append(v)

    return VectorTable(
        geometry=b.build(),
        columns={"layer": np.asarray(layers)} if layers else {},
    )
