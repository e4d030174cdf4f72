"""FlatGeobuf (.fgb) vector reader/writer — hand-decoded flatbuffers.

Reference analog: the OGR "FlatGeobuf" driver reachable through
`datasource/OGRFileFormat.scala:26-47` (any driver name). FlatGeobuf is a
flatbuffers-framed columnar format: magic, a Header table (schema columns,
geometry type, CRS, feature count, spatial-index node size), an optional
packed Hilbert R-tree, then length-prefixed Feature tables whose Geometry
carries coordinates as flat ``xy`` vectors with ``ends`` part splits.

No flatbuffers library exists in this environment, so both directions
speak the wire format directly: a ~60-line table decoder (vtable-indirect
field access) and a tiny prepend-style builder for the writer. The writer
emits no spatial index (``index_node_size = 0``) — legal per spec, and
the reader skips any index it finds by the published node-count formula.
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.types import GeometryBuilder, GeometryType, close_ring, open_ring
from .vector import VectorTable

MAGIC = b"fgb\x03fgb\x00"

# feature.fbs GeometryType -> packed GeometryType
_GEOM_TYPES = {
    1: GeometryType.POINT,
    2: GeometryType.LINESTRING,
    3: GeometryType.POLYGON,
    4: GeometryType.MULTIPOINT,
    5: GeometryType.MULTILINESTRING,
    6: GeometryType.MULTIPOLYGON,
    7: GeometryType.GEOMETRYCOLLECTION,
}

# header.fbs ColumnType ordinals
_COL_BYTE, _COL_UBYTE, _COL_BOOL = 0, 1, 2
_COL_SHORT, _COL_USHORT, _COL_INT, _COL_UINT = 3, 4, 5, 6
_COL_LONG, _COL_ULONG, _COL_FLOAT, _COL_DOUBLE = 7, 8, 9, 10
_COL_STRING, _COL_JSON, _COL_DATETIME, _COL_BINARY = 11, 12, 13, 14

_FIXED_FMT = {
    _COL_BYTE: "b", _COL_UBYTE: "B", _COL_BOOL: "?",
    _COL_SHORT: "h", _COL_USHORT: "H", _COL_INT: "i", _COL_UINT: "I",
    _COL_LONG: "q", _COL_ULONG: "Q", _COL_FLOAT: "f", _COL_DOUBLE: "d",
}


# --------------------------------------------------------------------------
# flatbuffers table decoding
# --------------------------------------------------------------------------


class _Table:
    """One flatbuffers table: vtable-indirect access to its fields."""

    __slots__ = ("buf", "pos", "vt", "vt_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        soff = struct.unpack_from("<i", buf, pos)[0]
        self.vt = pos - soff
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, slot: int) -> int:
        """Absolute position of field ``slot``, or 0 when absent."""
        vo = 4 + 2 * slot
        if vo >= self.vt_len:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vt + vo)[0]
        return self.pos + off if off else 0

    def scalar(self, slot: int, fmt: str, default=0):
        p = self._field(slot)
        return struct.unpack_from("<" + fmt, self.buf, p)[0] if p else default

    def _indirect(self, p: int) -> int:
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def string(self, slot: int) -> str | None:
        p = self._field(slot)
        if not p:
            return None
        v = self._indirect(p)
        n = struct.unpack_from("<I", self.buf, v)[0]
        return self.buf[v + 4 : v + 4 + n].decode("utf-8")

    def vector(self, slot: int, dtype) -> np.ndarray | None:
        p = self._field(slot)
        if not p:
            return None
        v = self._indirect(p)
        n = struct.unpack_from("<I", self.buf, v)[0]
        return np.frombuffer(self.buf, dtype=dtype, count=n, offset=v + 4)

    def table(self, slot: int) -> "_Table | None":
        p = self._field(slot)
        return _Table(self.buf, self._indirect(p)) if p else None

    def table_vector(self, slot: int) -> "list[_Table]":
        p = self._field(slot)
        if not p:
            return []
        v = self._indirect(p)
        n = struct.unpack_from("<I", self.buf, v)[0]
        return [
            _Table(self.buf, self._indirect(v + 4 + 4 * i)) for i in range(n)
        ]

    def bytes_vector(self, slot: int) -> bytes:
        p = self._field(slot)
        if not p:
            return b""
        v = self._indirect(p)
        n = struct.unpack_from("<I", self.buf, v)[0]
        return bytes(self.buf[v + 4 : v + 4 + n])


def _root(buf: bytes) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------


def _index_bytes(num_items: int, node_size: int) -> int:
    """Size of the packed Hilbert R-tree (40-byte nodes), per the spec's
    level-count recurrence."""
    if node_size < 2 or num_items == 0:
        return 0
    n, total = num_items, num_items
    while n != 1:
        n = (n + node_size - 1) // node_size
        total += n
    return total * 40


def _emit_geometry(b: GeometryBuilder, g: _Table | None, gtype: int,
                   srid: int, has_z: bool) -> None:
    """Append one Feature geometry (possibly nested parts) to the builder."""
    t = _GEOM_TYPES.get(gtype)
    if g is None:  # null geometry row -> empty collection, as GeoJSON path
        b.end_part()
        b.end_geom(GeometryType.GEOMETRYCOLLECTION, srid)
        return
    if t is None:
        raise ValueError(f"unsupported FlatGeobuf geometry type {gtype}")
    if t in (GeometryType.MULTIPOLYGON, GeometryType.GEOMETRYCOLLECTION):
        parts = g.table_vector(7)
        if t == GeometryType.GEOMETRYCOLLECTION:
            from ..core.geometry.collection import end_collection

            members = []
            for pt in parts:
                sub = GeometryBuilder()
                ptype = pt.scalar(6, "B", 0)
                _emit_geometry(sub, pt, ptype, srid, has_z)
                members.append((_GEOM_TYPES[ptype], sub.build()))
            end_collection(b, members, srid)
            return
        for pt in parts:  # each part: one Polygon table
            _polygon_rings(b, pt, has_z)
        b.end_geom(t, srid)
        return
    xy = g.vector(1, "<f8")
    xy = (
        np.asarray(xy, dtype=np.float64).reshape(-1, 2)
        if xy is not None
        else np.zeros((0, 2))
    )
    z = g.vector(2, "<f8") if has_z else None
    if t == GeometryType.POINT or t == GeometryType.LINESTRING:
        b.add_ring(xy, None if z is None else np.asarray(z))
        b.end_part()
    elif t == GeometryType.MULTIPOINT:
        for i in range(xy.shape[0]):
            b.add_ring(xy[i : i + 1], None if z is None else z[i : i + 1])
            b.end_part()
    elif t == GeometryType.MULTILINESTRING:
        for s, e in _part_slices(g, xy.shape[0]):
            b.add_ring(xy[s:e], None if z is None else z[s:e])
            b.end_part()
    elif t == GeometryType.POLYGON:
        _polygon_rings(b, g, has_z)
    b.end_geom(t, srid)


def _part_slices(g: _Table, n_coords: int):
    ends = g.vector(0, "<u4")
    if ends is None or len(ends) == 0:
        return [(0, n_coords)]
    out, s = [], 0
    for e in ends.tolist():
        out.append((s, int(e)))
        s = int(e)
    return out


def _polygon_rings(b: GeometryBuilder, g: _Table, has_z: bool) -> None:
    """One polygon (outer + holes): rings arrive closed (WKB convention),
    stored open in the packed layout."""
    xy = g.vector(1, "<f8")
    xy = (
        np.asarray(xy, dtype=np.float64).reshape(-1, 2)
        if xy is not None
        else np.zeros((0, 2))
    )
    z = g.vector(2, "<f8") if has_z else None
    for s, e in _part_slices(g, xy.shape[0]):
        rxy, rz = open_ring(xy[s:e], None if z is None else np.asarray(z[s:e]))
        b.add_ring(rxy, rz)
    b.end_part()


def _decode_properties(buf: bytes, cols: list[tuple[str, int]]) -> dict:
    out: dict = {}
    p, n = 0, len(buf)
    while p + 2 <= n:
        (ci,) = struct.unpack_from("<H", buf, p)
        p += 2
        if ci >= len(cols):
            raise ValueError(f"properties reference unknown column {ci}")
        name, ct = cols[ci]
        fmt = _FIXED_FMT.get(ct)
        if fmt is not None:
            (val,) = struct.unpack_from("<" + fmt, buf, p)
            p += struct.calcsize(fmt)
            out[name] = val
        elif ct in (_COL_STRING, _COL_JSON, _COL_DATETIME, _COL_BINARY):
            (ln,) = struct.unpack_from("<I", buf, p)
            p += 4
            raw = buf[p : p + ln]
            p += ln
            out[name] = raw if ct == _COL_BINARY else raw.decode("utf-8")
        else:
            raise ValueError(f"unsupported FlatGeobuf column type {ct}")
    return out


def read_flatgeobuf(path: str) -> VectorTable:
    """FlatGeobuf file -> :class:`VectorTable` (typed attribute columns)."""
    from .vector import props_to_columns

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != MAGIC[:8]:
        # verify the 'fgb' magic but accept any patch level (byte 7)
        if data[:4] != MAGIC[:4] or data[4:7] != MAGIC[4:7]:
            raise ValueError(f"not a FlatGeobuf file: {path}")
    p = 8
    (hlen,) = struct.unpack_from("<I", data, p)
    p += 4
    header = _root(data[p : p + hlen])
    p += hlen
    gtype = header.scalar(2, "B", 0)
    has_z = bool(header.scalar(3, "?", False))
    cols = [
        (c.string(0) or f"col{i}", c.scalar(1, "B", 0))
        for i, c in enumerate(header.table_vector(7))
    ]
    n_feat = header.scalar(8, "Q", 0)
    node_size = header.scalar(9, "H", 16)
    crs = header.table(10)
    srid = crs.scalar(1, "i", 0) if crs is not None else 0
    if srid <= 0:
        srid = 4326  # FGB default CRS is OGC:CRS84 (lon/lat)
    p += _index_bytes(n_feat, node_size)

    b = GeometryBuilder()
    props: list[dict] = []
    # bound by the promised count when the header carries one: trailing
    # bytes after the last feature must not be misread as a frame
    while p + 4 <= len(data) and (n_feat == 0 or len(props) < n_feat):
        (flen,) = struct.unpack_from("<I", data, p)
        p += 4
        if p + flen > len(data):
            raise ValueError(
                f"FlatGeobuf feature frame at byte {p - 4} overruns the file"
            )
        feat = _root(data[p : p + flen])
        p += flen
        g = feat.table(0)
        # per-feature type wins for heterogeneous (Unknown) collections
        ftype = g.scalar(6, "B", 0) if g is not None else 0
        _emit_geometry(b, g, ftype or gtype, srid, has_z)
        props.append(_decode_properties(feat.bytes_vector(1), cols))
    if n_feat and len(props) != n_feat:
        raise ValueError(
            f"FlatGeobuf header promises {n_feat} features, found {len(props)}"
        )
    return VectorTable(geometry=b.build(), columns=props_to_columns(props))


# --------------------------------------------------------------------------
# writer (fixture-grade: no spatial index)
# --------------------------------------------------------------------------


class _Builder:
    """Tiny prepend-style flatbuffers builder.

    Offsets are tracked as distances from the END of the buffer (the file
    grows by prepending), so a stored UOffset is simply
    ``field_distance - target_distance``. O(n^2) appends — fine for the
    fixture/writer scale this supports."""

    def __init__(self):
        self.buf = bytearray()

    @property
    def dist(self) -> int:
        return len(self.buf)

    def _prepend(self, raw: bytes) -> None:
        self.buf[:0] = raw

    def _align(self, size: int, extra: int = 0) -> None:
        while (len(self.buf) + extra) % size:
            self._prepend(b"\x00")

    def string(self, s: str) -> int:
        # file order [u32 len][bytes][NUL][pad]: padding is prepended
        # FIRST (prepends land at lower addresses, so earlier prepends sit
        # closer to the file end) to keep the length adjacent to the bytes
        raw = s.encode("utf-8") + b"\x00"
        self._align(4, extra=len(raw))
        self._prepend(raw)
        self._prepend(struct.pack("<I", len(raw) - 1))
        return self.dist

    def vector_scalar(self, fmt: str, vals) -> int:
        raw = b"".join(struct.pack("<" + fmt, v) for v in vals)
        self._align(max(4, struct.calcsize(fmt)), extra=len(raw))
        self._prepend(raw)
        self._prepend(struct.pack("<I", len(vals)))
        return self.dist

    def vector_offsets(self, offs: list[int]) -> int:
        self._align(4, extra=4 * len(offs))
        for o in reversed(offs):
            self._prepend(struct.pack("<I", self.dist + 4 - o))
        self._prepend(struct.pack("<I", len(offs)))
        return self.dist

    def table(self, fields: "dict[int, tuple]") -> int:
        """fields: slot -> ("scalar", fmt, value) | ("offset", target_dist).

        Layout: [soffset32][fields in slot order, aligned]; the vtable is
        prepended immediately before the table, so soffset == len(vtable).
        """
        slots = sorted(fields)
        n_slots = (max(slots) + 1) if slots else 0
        vt_len = 4 + 2 * n_slots
        # lay out field positions within the table (after the 4B soffset)
        pos: dict[int, int] = {}
        cur = 4
        blobs: dict[int, bytes] = {}
        for s in slots:
            kind = fields[s]
            if kind[0] == "scalar":
                raw = struct.pack("<" + kind[1], kind[2])
            else:
                raw = b"\x00\x00\x00\x00"  # patched below
            size = len(raw)
            align = min(size, 8) or 1
            cur = (cur + align - 1) // align * align
            pos[s] = cur
            blobs[s] = raw
            cur += size
        t_len = (cur + 3) // 4 * 4
        table = bytearray(t_len)
        struct.pack_into("<i", table, 0, vt_len)  # soffset -> vtable
        self._align(8, extra=t_len)  # 8-byte scalars inside stay aligned
        table_dist = self.dist + t_len  # distance of table start, once laid
        for s in slots:
            kind = fields[s]
            if kind[0] == "offset":
                field_dist = table_dist - pos[s]
                struct.pack_into(
                    "<I", table, pos[s], field_dist - kind[1]
                )
            else:
                table[pos[s] : pos[s] + len(blobs[s])] = blobs[s]
        self._prepend(bytes(table))
        vt = struct.pack("<HH", vt_len, t_len) + b"".join(
            struct.pack("<H", pos.get(s, 0)) for s in range(n_slots)
        )
        self._prepend(vt)
        return table_dist

    def finish(self, root_dist: int) -> bytes:
        # final length ≡ 0 mod 8 makes every dist-aligned object
        # address-aligned (addr = total_len - dist)
        self._align(8, extra=4)
        self._prepend(struct.pack("<I", self.dist + 4 - root_dist))
        return bytes(self.buf)


def _geometry_fields(b: _Builder, col, g: int, gtype: GeometryType):
    """Build the Geometry table contents for geometry ``g``; returns the
    table's field dict (coordinates closed back up for polygon rings,
    Z riding the parallel slot-2 vector when the geometry carries it)."""
    fields: dict[int, tuple] = {}
    t = gtype
    with_z = col.has_z(g)
    if t == GeometryType.MULTIPOLYGON:
        parts = []
        for p in col.geom_parts(g):
            sub: dict[int, tuple] = {}
            _rings_into(b, col, [p], sub, with_z)
            parts.append(b.table(sub))
        fields[7] = ("offset", b.vector_offsets(parts))
        fields[6] = ("scalar", "B", 6)
        return fields
    if t == GeometryType.GEOMETRYCOLLECTION:
        # packed columns never hold multi-member collections (parse
        # collapses them, core/geometry/collection.py); only the EMPTY
        # marker survives, which the caller writes as a null geometry
        raise ValueError("GEOMETRYCOLLECTION has no FlatGeobuf geometry")
    if t == GeometryType.POLYGON:
        _rings_into(b, col, list(col.geom_parts(g)), fields, with_z)
    else:
        xy = col.geom_xy(g)
        if t == GeometryType.MULTILINESTRING:
            ends, n = [], 0
            for p in col.geom_parts(g):
                for r in col.part_rings(p):
                    n += col.ring_xy(r).shape[0]
                    ends.append(n)
            if len(ends) > 1:
                fields[0] = ("offset", b.vector_scalar("I", ends))
        fields[1] = ("offset", b.vector_scalar("d", xy.reshape(-1).tolist()))
        if with_z:
            z = col.z[col.geom_vertex_slice(g)]
            fields[2] = ("offset", b.vector_scalar("d", z.tolist()))
    fields[6] = ("scalar", "B", int(_WKB_OF[t]))
    return fields


def _rings_into(b: _Builder, col, parts, fields, with_z: bool) -> None:
    """Closed-ring xy (+z) and ends vectors for one polygon's parts."""
    chunks, zchunks, ends, n = [], [], [], 0
    for p in parts:
        for r in col.part_rings(p):
            xy, z = close_ring(
                col.ring_xy(r), col.ring_z(r) if with_z else None
            )
            chunks.append(xy)
            if with_z:
                zchunks.append(z)
            n += xy.shape[0]
            ends.append(n)
    xy_all = np.vstack(chunks) if chunks else np.zeros((0, 2))
    if len(ends) > 1:
        fields[0] = ("offset", b.vector_scalar("I", ends))
    fields[1] = ("offset", b.vector_scalar("d", xy_all.reshape(-1).tolist()))
    if with_z:
        z_all = np.concatenate(zchunks) if zchunks else np.zeros(0)
        fields[2] = ("offset", b.vector_scalar("d", z_all.tolist()))


_WKB_OF = {
    GeometryType.POINT: 1,
    GeometryType.LINESTRING: 2,
    GeometryType.POLYGON: 3,
    GeometryType.MULTIPOINT: 4,
    GeometryType.MULTILINESTRING: 5,
    GeometryType.MULTIPOLYGON: 6,
    GeometryType.GEOMETRYCOLLECTION: 7,
}


def write_flatgeobuf(path: str, table: VectorTable, name: str = "layer",
                     srid: int = 4326) -> None:
    """Write a VectorTable as FlatGeobuf (no spatial index; string and
    float columns — the writer exists to round-trip fixtures and exports,
    not to replace a full OGR writer)."""
    col = table.geometry
    types = {col.geometry_type(g) for g in range(len(col))}
    gtype = _WKB_OF[next(iter(types))] if len(types) == 1 else 0

    cols: list[tuple[str, int]] = []
    for k, v in table.columns.items():
        ct = _COL_DOUBLE if np.issubdtype(
            np.asarray(v).dtype, np.floating
        ) else _COL_STRING
        cols.append((k, ct))

    out = bytearray(MAGIC)

    hb = _Builder()
    col_offs = [
        hb.table({0: ("offset", hb.string(k)), 1: ("scalar", "B", ct)})
        for k, ct in cols
    ]
    hfields: dict[int, tuple] = {
        0: ("offset", hb.string(name)),
        2: ("scalar", "B", gtype),
        8: ("scalar", "Q", len(col)),
    }
    if any(col.has_z(g) for g in range(len(col))):
        hfields[3] = ("scalar", "?", True)
    hfields.update({
        9: ("scalar", "H", 0),  # no spatial index
        10: ("offset", hb.table({
            0: ("offset", hb.string("EPSG")),
            1: ("scalar", "i", int(srid)),
        })),
    })
    if col_offs:
        hfields[7] = ("offset", hb.vector_offsets(col_offs))
    hdr = hb.finish(hb.table(hfields))
    out += struct.pack("<I", len(hdr)) + hdr

    for g in range(len(col)):
        fb = _Builder()
        gt = col.geometry_type(g)
        if gt == GeometryType.GEOMETRYCOLLECTION:
            geom_off = None  # empty collection == null-geometry feature
        else:
            geom_off = fb.table(_geometry_fields(fb, col, g, gt))
        props = bytearray()
        for ci, (k, ct) in enumerate(cols):
            v = table.columns[k][g]
            props += struct.pack("<H", ci)
            if ct == _COL_DOUBLE:
                props += struct.pack("<d", float(v))
            else:
                raw = str(v).encode("utf-8")
                props += struct.pack("<I", len(raw)) + raw
        ffields: dict[int, tuple] = (
            {} if geom_off is None else {0: ("offset", geom_off)}
        )
        if props:
            ffields[1] = ("offset", fb.vector_scalar("B", list(props)))
        feat = fb.finish(fb.table(ffields))
        out += struct.pack("<I", len(feat)) + feat

    with open(path, "wb") as f:
        f.write(out)
