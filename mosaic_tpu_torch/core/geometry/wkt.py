"""WKT reader/writer to/from :class:`PackedGeometry`.

Port of ``mosaic_tpu/core/geometry/wkt.py``, line for line (a copy kept
in the port so that it never imports the JAX package).

Reference analog: the JTS/ESRI WKT readers behind
`core/geometry/api/GeometryAPI.scala:64-72` and the `st_geomfromwkt` /
`st_aswkt` expressions. Implemented from scratch on numpy — coordinate runs
are parsed with ``np.fromstring``-style bulk conversion rather than per-token
loops where possible.
"""

from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np

from ..types import GeometryBuilder, GeometryType, PackedGeometry, open_ring
from ..types import close_ring as _close_ring_xy

_TYPE_RE = re.compile(
    r"\s*(POINT|LINESTRING|POLYGON|MULTIPOINT|MULTILINESTRING|MULTIPOLYGON|"
    r"GEOMETRYCOLLECTION)\s*(ZM|Z|M)?\s*(EMPTY)?",
    re.IGNORECASE,
)
_SRID_RE = re.compile(r"\s*SRID\s*=\s*(\d+)\s*;", re.IGNORECASE)


def _parse_coord_run(
    text: str, dims: int, m_only: bool = False
) -> tuple[np.ndarray, np.ndarray | None]:
    """Parse 'x y[ z[ m]], ...' into (N,2) xy and optional z.

    ``m_only`` marks a 3-dim run whose third value is a measure (XYM) — the
    measure is discarded rather than mistaken for elevation.
    """
    tokens = text.replace(",", " ").split()
    vals = np.asarray(tokens, dtype=np.float64) if tokens else np.zeros(0)
    if vals.size == 0:
        return np.zeros((0, 2)), None
    if dims == 0:  # infer from count of one tuple
        first = text.split(",")[0].split()
        dims = len(first)
    if vals.size % dims:
        raise ValueError(f"malformed WKT coordinate run: {text[:60]!r}")
    vals = vals.reshape(-1, dims)
    z = vals[:, 2].copy() if (dims >= 3 and not m_only) else None
    return np.ascontiguousarray(vals[:, :2]), z


class _Cursor:
    __slots__ = ("s", "i")

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def skip_ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def expect(self, ch: str):
        self.skip_ws()
        if self.i >= len(self.s) or self.s[self.i] != ch:
            got = self.s[self.i : self.i + 10] if self.i < len(self.s) else "<eof>"
            raise ValueError(f"WKT parse error: expected {ch!r} at {got!r}")
        self.i += 1

    def peek(self) -> str:
        self.skip_ws()
        return self.s[self.i] if self.i < len(self.s) else ""

    def take_until_close(self) -> str:
        """Consume a '(...)'-free span up to the matching close paren."""
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in "()":
            self.i += 1
        return self.s[start : self.i]


def _parse_ring_list(
    cur: _Cursor, dims: int, m_only: bool = False
) -> list[tuple[np.ndarray, np.ndarray | None]]:
    """Parse '((...),(...))' -> list of rings."""
    rings = []
    cur.expect("(")
    while True:
        cur.expect("(")
        xy, z = _parse_coord_run(cur.take_until_close(), dims, m_only)
        cur.expect(")")
        rings.append((xy, z))
        if cur.peek() == ",":
            cur.i += 1
            continue
        break
    cur.expect(")")
    return rings


def _append_wkt(builder: GeometryBuilder, wkt: str, srid: int) -> None:
    m = _SRID_RE.match(wkt)
    if m:
        srid = int(m.group(1))
        wkt = wkt[m.end() :]
    _parse_typed(builder, _Cursor(wkt), srid)


def _parse_typed(
    builder: GeometryBuilder, cur: _Cursor, srid: int
) -> GeometryType:
    """Parse one typed geometry at the cursor; returns the DECLARED type
    (a GEOMETRYCOLLECTION resolves per the reference's first-polygonal
    semantics but still reports itself as a collection to its caller)."""
    cur.skip_ws()
    m = _TYPE_RE.match(cur.s, cur.i)
    if not m:
        raise ValueError(f"invalid WKT: {cur.s[cur.i : cur.i + 60]!r}")
    gtype = GeometryType.from_name(m.group(1))
    zm = (m.group(2) or "").upper()
    dims = 4 if zm == "ZM" else (3 if zm in ("Z", "M") else 0)
    m_only = zm == "M"
    if m.group(3):  # EMPTY
        cur.i = m.end()
        builder.end_part()
        builder.end_geom(gtype, srid)
        return gtype
    cur.i = m.end()

    close_ring = open_ring  # store rings open-form; drop explicit closing vertex

    if gtype == GeometryType.POINT:
        cur.expect("(")
        xy, z = _parse_coord_run(cur.take_until_close(), dims, m_only)
        cur.expect(")")
        builder.add_ring(xy, z)
        builder.end_part()
    elif gtype == GeometryType.LINESTRING:
        cur.expect("(")
        xy, z = _parse_coord_run(cur.take_until_close(), dims, m_only)
        cur.expect(")")
        builder.add_ring(xy, z)
        builder.end_part()
    elif gtype == GeometryType.POLYGON:
        for xy, z in _parse_ring_list(cur, dims, m_only):
            xy, z = close_ring(xy, z)
            builder.add_ring(xy, z)
        builder.end_part()
    elif gtype == GeometryType.MULTIPOINT:
        cur.expect("(")
        if cur.peek() == "(":
            # MULTIPOINT ((1 2), (3 4)) form
            while True:
                cur.expect("(")
                xy, z = _parse_coord_run(cur.take_until_close(), dims, m_only)
                cur.expect(")")
                builder.add_ring(xy, z)
                builder.end_part()
                if cur.peek() == ",":
                    cur.i += 1
                    continue
                break
            cur.expect(")")
        else:
            xy, z = _parse_coord_run(cur.take_until_close(), dims, m_only)
            cur.expect(")")
            for k in range(xy.shape[0]):
                builder.add_ring(xy[k : k + 1], None if z is None else z[k : k + 1])
                builder.end_part()
    elif gtype == GeometryType.MULTILINESTRING:
        for xy, z in _parse_ring_list(cur, dims, m_only):
            builder.add_ring(xy, z)
            builder.end_part()
    elif gtype == GeometryType.MULTIPOLYGON:
        cur.expect("(")
        while True:
            for xy, z in _parse_ring_list(cur, dims, m_only):
                xy, z = close_ring(xy, z)
                builder.add_ring(xy, z)
            builder.end_part()
            if cur.peek() == ",":
                cur.i += 1
                continue
            break
        cur.expect(")")
    else:  # GEOMETRYCOLLECTION: reference first-polygonal semantics
        from .collection import end_collection

        cur.expect("(")
        members = []
        while True:
            sub = GeometryBuilder()
            declared = _parse_typed(sub, cur, srid)
            members.append((declared, sub.build()))
            if cur.peek() == ",":
                cur.i += 1
                continue
            break
        cur.expect(")")
        end_collection(builder, members, srid)
        return gtype
    builder.end_geom(gtype, srid)
    return gtype


def from_wkt(wkts: Sequence[str] | str, srid: int = 4326) -> PackedGeometry:
    if isinstance(wkts, str):
        wkts = [wkts]
    builder = GeometryBuilder()
    for w in wkts:
        _append_wkt(builder, w, srid)
    return builder.build()


def _num(v) -> str:
    """Shortest string that round-trips the float exactly (Python repr,
    integral values as bare ints); .15g dropped up to 2 significant
    digits, so WKT was a lossy codec."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e16:
        i = str(int(f))
        # keep -0.0's sign (int() drops it; '%.15g' printed '-0' too)
        return "-0" if i == "0" and math.copysign(1.0, f) < 0 else i
    return repr(f)


def _fmt_coords(xy: np.ndarray, z: np.ndarray | None, close: bool = False) -> str:
    pts, zz = (_close_ring_xy(xy, z) if close else (xy, z))
    if zz is not None:
        return ",".join(
            f"{_num(p[0])} {_num(p[1])} {_num(w)}" for p, w in zip(pts, zz)
        )
    return ",".join(f"{_num(p[0])} {_num(p[1])}" for p in pts)


def to_wkt(col: PackedGeometry) -> list[str]:
    out = []
    for g in range(len(col)):
        gt = col.geometry_type(g)
        parts = list(col.geom_parts(g))
        hz = col.has_z(g)

        def ring_z(r):
            return col.ring_z(r) if hz else None

        if not parts or col.geom_xy(g).shape[0] == 0:
            out.append(f"{gt.wkt_name} EMPTY")
            continue
        if gt == GeometryType.POINT:
            r = next(iter(col.part_rings(parts[0])))
            out.append(f"POINT ({_fmt_coords(col.ring_xy(r), ring_z(r))})")
        elif gt == GeometryType.LINESTRING:
            r = next(iter(col.part_rings(parts[0])))
            out.append(f"LINESTRING ({_fmt_coords(col.ring_xy(r), ring_z(r))})")
        elif gt == GeometryType.POLYGON:
            rings = [
                f"({_fmt_coords(col.ring_xy(r), ring_z(r), close=True)})"
                for r in col.part_rings(parts[0])
            ]
            out.append(f"POLYGON ({','.join(rings)})")
        elif gt == GeometryType.MULTIPOINT:
            pts = []
            for p in parts:
                for r in col.part_rings(p):
                    pts.append(f"({_fmt_coords(col.ring_xy(r), ring_z(r))})")
            out.append(f"MULTIPOINT ({','.join(pts)})")
        elif gt == GeometryType.MULTILINESTRING:
            lines = []
            for p in parts:
                for r in col.part_rings(p):
                    lines.append(f"({_fmt_coords(col.ring_xy(r), ring_z(r))})")
            out.append(f"MULTILINESTRING ({','.join(lines)})")
        elif gt == GeometryType.MULTIPOLYGON:
            polys = []
            for p in parts:
                rings = [
                    f"({_fmt_coords(col.ring_xy(r), ring_z(r), close=True)})"
                    for r in col.part_rings(p)
                ]
                polys.append(f"({','.join(rings)})")
            out.append(f"MULTIPOLYGON ({','.join(polys)})")
        else:
            raise NotImplementedError(gt)
    return out
