"""MapInfo Interchange Format (MIF/MID) reader.

Reference analog: the reference's `OGRFileFormat` accepts any OGR driver
name including "MapInfo File"
(`datasource/OGRFileFormat.scala:26-47,441-473`); this is the TAB/MIF
half of that breadth implemented from the published MIF spec — the ASCII
interchange form (binary .tab is MapInfo-internal and OGR itself
recommends MIF for exchange).

Supported objects: POINT, MULTIPOINT, LINE, PLINE [MULTIPLE], REGION
(ring nesting resolved by containment — MIF does not mark holes), NONE.
Attributes come from the .mid file typed by the COLUMNS block; DELIMITER
is honored. PEN/BRUSH/SYMBOL/CENTER styling clauses are skipped.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core.geometry.hostops import _emit_polygon, _nest_contours
from ..core.types import GeometryBuilder, GeometryType
from .vector import VectorTable


def _emit_region(b: GeometryBuilder, rings: list[np.ndarray], srid: int):
    """MIF regions carry no hole flags: a ring is a hole of the ring that
    contains it (even-odd). Nesting rides hostops' boundary-robust
    machinery (`_nest_contours` probes a point clear of shared vertices —
    MIF holes routinely touch their shells)."""
    rings = [r for r in rings if r.shape[0] >= 3]
    _emit_polygon(b, _nest_contours(rings), srid)


def _parse_mid(path: Path, names: list[str], types: list[str], delim: str):
    import csv
    import io

    cols: dict[str, list] = {n: [] for n in names}
    if not path.exists() or not names:
        return cols
    # stdlib csv handles quoted delimiters and MID's doubled-quote escape
    # (the same pattern as readers/vector.py's csv_points)
    text = path.read_text(errors="replace")
    for vals in csv.reader(io.StringIO(text), delimiter=delim):
        if not vals:
            continue
        # a short row (trailing empty field with no delimiter) must not
        # truncate the zip and silently drop whole columns
        vals += [""] * (len(names) - len(vals))
        for n, t, v in zip(names, types, vals):
            v = v.strip()
            if t in ("integer", "smallint"):
                cols[n].append(int(v) if v else 0)
            elif t in ("float", "decimal"):
                cols[n].append(float(v) if v else np.nan)
            else:
                cols[n].append(v)
    return cols


def read_mif(path: str) -> VectorTable:
    """Read `path` (.mif, with its .mid sidecar) into a VectorTable."""
    p = Path(path)
    text = p.read_text(errors="replace")
    lines = [ln.strip() for ln in text.splitlines()]
    delim = "\t"
    names: list[str] = []
    types: list[str] = []
    i = 0
    # ------------------------------------------------------------ header
    while i < len(lines):
        ln = lines[i]
        up = ln.upper()
        if up.startswith("DELIMITER"):
            q = ln.split('"')
            if len(q) >= 2 and q[1]:
                delim = q[1]
        elif up.startswith("COLUMNS"):
            n = int(ln.split()[1])
            for k in range(n):
                i += 1
                parts = lines[i].split()
                names.append(parts[0])
                types.append(parts[1].split("(")[0].lower())
        elif up.startswith("DATA"):
            i += 1
            break
        i += 1
    # ------------------------------------------------------- object list
    b = GeometryBuilder()
    count = 0

    def floats(ln: str) -> list[float]:
        return [float(t) for t in ln.replace(",", " ").split()]

    def read_ring(k: int) -> np.ndarray:
        nonlocal i
        out = np.empty((k, 2))
        for v in range(k):
            out[v] = floats(lines[i])[:2]
            i += 1
        return out

    n_lines = len(lines)
    while i < n_lines:
        ln = lines[i]
        if not ln:
            i += 1
            continue
        tok = ln.split()
        kw = tok[0].upper()
        i += 1
        if kw in ("PEN", "BRUSH", "SYMBOL", "SMOOTH", "CENTER"):
            continue  # styling clauses attached to the previous object
        if kw == "NONE":
            b.add_geometry(GeometryType.POINT, [[np.zeros((0, 2))]], 0)
        elif kw == "POINT":
            xy = np.asarray([[float(tok[1]), float(tok[2])]])
            b.add_geometry(GeometryType.POINT, [[xy]], 0)
        elif kw == "MULTIPOINT":
            k = int(tok[1])
            pts = read_ring(k)
            b.add_geometry(
                GeometryType.MULTIPOINT, [[row[None, :]] for row in pts], 0
            )
        elif kw == "LINE":
            xy = np.asarray(
                [[float(tok[1]), float(tok[2])], [float(tok[3]), float(tok[4])]]
            )
            b.add_geometry(GeometryType.LINESTRING, [[xy]], 0)
        elif kw == "PLINE":
            if len(tok) >= 3 and tok[1].upper() == "MULTIPLE":
                parts = []
                for _ in range(int(tok[2])):
                    k = int(lines[i])
                    i += 1
                    parts.append([read_ring(k)])
                b.add_geometry(GeometryType.MULTILINESTRING, parts, 0)
            else:
                k = int(tok[1]) if len(tok) > 1 else int(lines[i])
                if len(tok) == 1:
                    i += 1
                b.add_geometry(GeometryType.LINESTRING, [[read_ring(k)]], 0)
        elif kw == "REGION":
            rings = []
            for _ in range(int(tok[1])):
                k = int(lines[i])
                i += 1
                r = read_ring(k)
                # MIF rings repeat the first vertex; drop the closure
                if r.shape[0] > 1 and np.allclose(r[0], r[-1]):
                    r = r[:-1]
                rings.append(r)
            _emit_region(b, rings, 0)
        else:
            # TEXT/RECT/ELLIPSE/ARC/... : consume the object's body (lines
            # up to the next keyword) and emit an EMPTY row so .mid
            # attribute rows stay aligned — OGR's skip-unsupported analog
            known = {
                "NONE", "POINT", "MULTIPOINT", "LINE", "PLINE", "REGION",
                "PEN", "BRUSH", "SYMBOL", "SMOOTH", "CENTER", "TEXT",
                "RECT", "ROUNDRECT", "ELLIPSE", "ARC", "COLLECTION",
                "FONT", "ANGLE", "JUSTIFY", "SPACING", "LABEL",
            }
            while i < n_lines:
                nxt = lines[i].split()
                first = nxt[0].upper() if nxt else ""
                if first in known and first not in (
                    "FONT", "ANGLE", "JUSTIFY", "SPACING", "LABEL"
                ):
                    break
                i += 1
            b.add_geometry(GeometryType.POINT, [[np.zeros((0, 2))]], 0)
        count += 1

    cols = _parse_mid(p.with_suffix(".mid"), names, types, delim)
    np_cols = {
        n: np.asarray(v)
        for n, v in cols.items()
        if len(v) == count  # tolerate missing/short .mid
    }
    return VectorTable(geometry=b.build(), columns=np_cols)
