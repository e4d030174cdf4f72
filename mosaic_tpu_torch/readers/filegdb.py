"""ESRI FileGDB (.gdb) vector reader — pure host decode, no GDAL.

Reference analog: the OpenFileGDB/FileGDB OGR drivers behind the
reference's `GeoDBFileFormat`/`OpenGeoDBFileFormat`
(`datasource/GeoDBFileFormat.scala:11-37`; fixture
`binary/geodb/bridges.gdb.zip`). Implements the reverse-engineered v10
`.gdbtable`/`.gdbtablx` layout:

- field descriptors (int16/32, float32/64, string, datetime, objectid,
  geometry with origin/scale quantization parameters)
- row store with nullable-field bitmasks and varuint-length strings
- geometry blobs: point, multipoint, polyline, polygon — bbox varuints +
  zigzag-delta-packed integer coordinates, dequantized via the layer's
  origin/scale
- layer discovery through the GDB_SystemCatalog table (a00000001)

Validated against the fixture's own LATITUDE/LONGITUDE attribute columns
(geometry decoded from UTM 18N agrees after `crs.to_wgs84`).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core.types import GeometryBuilder, GeometryType
from .vector import VectorTable


def _varuint(d: bytes, q: int) -> tuple[int, int]:
    v = 0
    s = 0
    while True:
        b = d[q]
        q += 1
        v |= (b & 0x7F) << s
        if not (b & 0x80):
            return v, q
        s += 7


def _varint(d: bytes, q: int) -> tuple[int, int]:
    """FileGDB signed varint: bit6 of the first byte is the sign."""
    b = d[q]
    q += 1
    neg = bool(b & 0x40)
    v = b & 0x3F
    s = 6
    while b & 0x80:
        b = d[q]
        q += 1
        v |= (b & 0x7F) << s
        s += 7
    return (-v if neg else v), q


class _Field:
    __slots__ = ("name", "ftype", "nullable")

    def __init__(self, name, ftype, nullable):
        self.name = name
        self.ftype = ftype
        self.nullable = nullable


class GdbTable:
    """One .gdbtable/.gdbtablx pair."""

    def __init__(self, base: str):
        self.base = base
        self._d = open(base + ".gdbtable", "rb").read()
        self._x = open(base + ".gdbtablx", "rb").read()
        d = self._d
        if struct.unpack("<I", d[0:4])[0] != 3:
            raise ValueError(f"{base}.gdbtable: bad magic")
        self.n_valid = struct.unpack("<I", d[4:8])[0]
        fdo = struct.unpack("<Q", d[32:40])[0]
        self._parse_fields(fdo)
        # tablx header: magic, n-1024-row-blocks, row counter, offset size
        _magic, n1024, _rowctr, osz = struct.unpack("<4I", self._x[:16])
        raw = np.frombuffer(
            self._x[16 : 16 + n1024 * 1024 * osz], dtype=np.uint8
        )
        raw = raw[: (raw.size // osz) * osz].reshape(-1, osz)
        offs = raw[:, 0].astype(np.int64)
        for i in range(1, osz):
            offs |= raw[:, i].astype(np.int64) << (8 * i)
        live = offs > 0
        self.row_offsets = offs[live]
        # object IDs are the 1-based tablx slot positions (deleted rows
        # leave zero-offset gaps but keep their slots)
        self.row_ids = np.nonzero(live)[0] + 1

    def _parse_fields(self, fdo: int):
        d = self._d
        nfields = struct.unpack("<H", d[fdo + 12 : fdo + 14])[0]
        q = fdo + 14
        self.fields: list[_Field] = []
        self.geom_field: str | None = None
        self.xyorigin = (0.0, 0.0)
        self.xyscale = 1.0
        self.zscale = 1.0
        self.srs_wkt = ""
        for _ in range(nfields):
            nlen = d[q]
            q += 1
            name = d[q : q + 2 * nlen].decode("utf-16-le")
            q += 2 * nlen
            alen = d[q]
            q += 1 + 2 * alen
            ftype = d[q]
            q += 1
            nullable = True
            if ftype in (0, 1, 2, 3, 5):  # numeric / datetime
                flag = d[q + 1]
                nullable = bool(flag & 1)
                q += 2
                if flag & 4:
                    q += 1 + d[q]  # default value
            elif ftype == 4 or ftype == 12:  # string / xml
                flag = d[q + 4]
                nullable = bool(flag & 1)
                q += 5
                if flag & 4:
                    dl, q2 = _varuint(d, q)
                    q = q2 + dl
            elif ftype == 6:  # objectid (not stored in rows)
                nullable = False
                q += 2
            elif ftype == 7:  # geometry
                flag = d[q + 1]
                nullable = bool(flag & 1)
                q += 2
                srlen = struct.unpack("<H", d[q : q + 2])[0]
                q += 2
                self.srs_wkt = d[q : q + srlen].decode("utf-16-le", "replace")
                q += srlen
                gflags = d[q]
                q += 1
                has_m = bool(gflags & 2)
                has_z = bool(gflags & 4)
                xo, yo, xys = struct.unpack("<3d", d[q : q + 24])
                q += 24
                if has_m:
                    q += 16
                if has_z:
                    zo, zs = struct.unpack("<2d", d[q : q + 16])
                    self.zscale = zs
                    q += 16
                q += 8  # xytolerance
                if has_m:
                    q += 8
                if has_z:
                    q += 8
                q += 32  # extent
                q += 1  # trailing byte
                (ngrids,) = struct.unpack("<I", d[q : q + 4])
                q += 4 + 8 * ngrids
                self.xyorigin = (xo, yo)
                self.xyscale = xys
                self.geom_field = name
                self.has_z = has_z
            elif ftype == 8:  # binary
                flag = d[q + 1]
                nullable = bool(flag & 1)
                q += 2
            elif ftype in (10, 11):  # UUID
                flag = d[q + 1]
                nullable = bool(flag & 1)
                q += 2
            else:
                raise ValueError(f"FileGDB field type {ftype} unsupported")
            self.fields.append(_Field(name, ftype, nullable))

    # ----------------------------------------------------------------- rows
    def rows(self):
        """Yield dicts of field values (geometry as raw blob bytes)."""
        d = self._d
        nullable_fields = [f for f in self.fields if f.nullable]
        nmask = (len(nullable_fields) + 7) // 8
        for ro in self.row_offsets:
            ro = int(ro)
            q = ro + 4
            mask = d[q : q + nmask]
            q += nmask
            ni = 0
            row = {}
            for f in self.fields:
                if f.ftype == 6:  # objectid: derived, not stored
                    continue
                if f.nullable:
                    is_null = bool(mask[ni >> 3] & (1 << (ni & 7)))
                    ni += 1
                    if is_null:
                        row[f.name] = None
                        continue
                if f.ftype == 0:
                    row[f.name] = struct.unpack("<h", d[q : q + 2])[0]
                    q += 2
                elif f.ftype == 1:
                    row[f.name] = struct.unpack("<i", d[q : q + 4])[0]
                    q += 4
                elif f.ftype == 2:
                    row[f.name] = struct.unpack("<f", d[q : q + 4])[0]
                    q += 4
                elif f.ftype in (3, 5):
                    row[f.name] = struct.unpack("<d", d[q : q + 8])[0]
                    q += 8
                elif f.ftype in (4, 12):
                    n, q = _varuint(d, q)
                    row[f.name] = d[q : q + n].decode("utf-8", "replace")
                    q += n
                elif f.ftype == 7:
                    n, q = _varuint(d, q)
                    row[f.name] = d[q : q + n]
                    q += n
                elif f.ftype == 8:
                    n, q = _varuint(d, q)
                    row[f.name] = d[q : q + n]
                    q += n
                elif f.ftype in (10, 11):
                    row[f.name] = d[q : q + 16].hex()
                    q += 16
            yield row

    # ------------------------------------------------------------- geometry
    def decode_geometry(self, blob: bytes, builder: GeometryBuilder, srid: int):
        """One geometry blob -> appended to the builder."""
        xo, yo = self.xyorigin
        sc = self.xyscale
        gt, q = _varuint(blob, 0)
        kind = gt & 0xFF
        if kind in (1, 9, 11, 21):  # point variants
            vx, q = _varuint(blob, q)
            vy, q = _varuint(blob, q)
            if vx == 0 and vy == 0:
                builder.add_geometry(GeometryType.POINT, [[np.zeros((0, 2))]], srid)
                return
            x = (vx - 1) / sc + xo
            y = (vy - 1) / sc + yo
            builder.add_geometry(
                GeometryType.POINT, [[np.asarray([[x, y]])]], srid
            )
            return
        if kind in (2, 8, 20):  # multipoint
            n, q = _varuint(blob, q)
            q = _skip_bbox(blob, q)
            xs, ys, q = _delta_coords(blob, q, n)
            pts = np.stack([xs / sc + xo, ys / sc + yo], axis=-1)
            builder.add_geometry(
                GeometryType.MULTIPOINT, [[p[None, :]] for p in pts], srid
            )
            return
        if kind in (3, 10, 13, 23, 25, 50, 51):  # polyline
            n, q = _varuint(blob, q)
            nparts, q = _varuint(blob, q)
            q = _skip_bbox(blob, q)
            counts, q = _part_counts(blob, q, n, nparts)
            xs, ys, q = _delta_coords(blob, q, n)
            pts = np.stack([xs / sc + xo, ys / sc + yo], axis=-1)
            parts = []
            s = 0
            for c in counts:
                parts.append([pts[s : s + c]])
                s += c
            builder.add_geometry(GeometryType.MULTILINESTRING, parts, srid)
            return
        if kind in (4, 5, 12, 15, 19, 24, 26, 27, 54):  # polygon
            n, q = _varuint(blob, q)
            nparts, q = _varuint(blob, q)
            q = _skip_bbox(blob, q)
            counts, q = _part_counts(blob, q, n, nparts)
            xs, ys, q = _delta_coords(blob, q, n)
            pts = np.stack([xs / sc + xo, ys / sc + yo], axis=-1)
            rings = []
            s = 0
            for c in counts:
                rings.append(pts[s : s + c])
                s += c
            # FileGDB stores all rings flat; ring orientation separates
            # shells (CW in ESRI) from holes — group holes with the
            # preceding shell
            parts = []
            for r in rings:
                area2 = float(
                    np.sum(r[:-1, 0] * r[1:, 1] - r[1:, 0] * r[:-1, 1])
                )
                if area2 <= 0 or not parts:  # ESRI shells are clockwise
                    parts.append([r])
                else:
                    parts[-1].append(r)
            builder.add_geometry(GeometryType.MULTIPOLYGON, parts, srid)
            return
        raise ValueError(f"FileGDB geometry type {kind} unsupported")


def _skip_bbox(blob: bytes, q: int) -> int:
    for _ in range(4):
        _, q = _varuint(blob, q)
    return q


def _part_counts(blob, q, n, nparts):
    counts = []
    rem = n
    for _ in range(max(nparts - 1, 0)):
        c, q = _varuint(blob, q)
        counts.append(c)
        rem -= c
    counts.append(rem)
    return counts, q


def _delta_coords(blob, q, n):
    xs = np.empty(n, dtype=np.float64)
    ys = np.empty(n, dtype=np.float64)
    x = y = 0
    for i in range(n):
        dx, q = _varint(blob, q)
        x += dx
        xs[i] = x
    for i in range(n):
        dy, q = _varint(blob, q)
        y += dy
        ys[i] = y
    return xs, ys, q


_SRS_SRIDS = {
    "NAD_1983_UTM_Zone_18N": 26918,
    "WGS_1984_UTM_Zone_18N": 32618,
    "GCS_WGS_1984": 4326,
    "GCS_North_American_1983": 4269,
}


def _srid_of(wkt: str) -> int:
    for name, srid in _SRS_SRIDS.items():
        if wkt.startswith(f'PROJCS["{name}"') or wkt.startswith(f'GEOGCS["{name}"'):
            return srid
    return 0


def list_gdb_layers(gdb_dir: str) -> dict[str, str]:
    """Layer name -> table file base, via the GDB_SystemCatalog (a1)."""
    catalog = os.path.join(gdb_dir, "a00000001")
    if not os.path.exists(catalog + ".gdbtable"):
        raise ValueError(
            f"{gdb_dir!r} is not a FileGDB directory (no GDB_SystemCatalog)"
        )
    cat = GdbTable(catalog)
    out = {}
    for oid, row in zip(cat.row_ids, cat.rows()):
        name = row.get("Name")
        if not name or name.startswith("GDB_"):
            continue
        base = os.path.join(gdb_dir, f"a{int(oid):08x}")
        if os.path.exists(base + ".gdbtable"):
            out[name] = base
    return out


def read_filegdb(path: str, layer: str | None = None) -> VectorTable:
    """A .gdb directory (or .zip of one) -> VectorTable of one layer."""
    import shutil
    import tempfile
    import zipfile

    tmp = None
    if path.endswith(".zip"):
        tmp = tempfile.mkdtemp(prefix="gdb_")
        with zipfile.ZipFile(path) as z:
            z.extractall(tmp)
        inner = [f for f in os.listdir(tmp) if f.endswith(".gdb")]
        if not inner:
            shutil.rmtree(tmp, ignore_errors=True)
            raise ValueError(f"no .gdb directory inside {path!r}")
        path = os.path.join(tmp, inner[0])
    try:
        return _read_gdb_dir(path, layer)
    finally:
        if tmp is not None:  # tables are fully in memory once read
            shutil.rmtree(tmp, ignore_errors=True)


def _read_gdb_dir(path: str, layer: "str | None") -> VectorTable:
    layers = list_gdb_layers(path)
    if not layers:
        raise ValueError(f"no feature layers in {path!r}")
    if layer is None:
        layer = next(iter(layers))
    elif layer not in layers:
        raise ValueError(f"layer {layer!r} not in {sorted(layers)}")
    t = GdbTable(layers[layer])
    srid = _srid_of(t.srs_wkt)
    b = GeometryBuilder()
    cols: dict[str, list] = {
        f.name: [] for f in t.fields if f.ftype not in (6, 7)
    }
    for row in t.rows():
        blob = row.get(t.geom_field) if t.geom_field else None
        if blob:
            t.decode_geometry(blob, b, srid or 0)
        else:
            b.add_geometry(GeometryType.POINT, [[np.zeros((0, 2))]], srid or 0)
        for name in cols:
            cols[name].append(row.get(name))
    columns: dict[str, np.ndarray] = {}
    for name, vals in cols.items():
        if all(isinstance(v, (int, float, type(None))) for v in vals) and any(
            v is not None for v in vals
        ):
            columns[name] = np.asarray(
                [np.nan if v is None else float(v) for v in vals]
            )
        else:
            columns[name] = np.asarray(vals, dtype=object)
    return VectorTable(geometry=b.build(), columns=columns)
