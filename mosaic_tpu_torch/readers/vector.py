"""Vector file readers: Shapefile (.shp/.dbf), GeoJSON, CSV points.

Reference analog: `datasource/OGRFileFormat.scala:26-473` (any OGR driver ->
rows with WKB + attribute columns, schema inferred by scanning features) and
the pinned-driver subclasses (`ShapefileFileFormat.scala:11-47`). Without
GDAL, the two formats the reference's test-suite exercises most — ESRI
Shapefile and GeoJSON — are decoded natively here; both produce a
:class:`VectorTable` (PackedGeometry column + numpy attribute columns), the
columnar analog of the OGR feature rows.

The ESRI shapefile main/dBASE formats are public specs; this decoder is
written to the spec, not to any other implementation.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from ..core.geometry.geojson import read_feature_collection
from ..core.types import GeometryBuilder, GeometryType, PackedGeometry


@dataclasses.dataclass
class VectorTable:
    """Geometry column + attribute columns (the OGR feature table analog)."""

    geometry: PackedGeometry
    columns: dict[str, np.ndarray]

    def __len__(self) -> int:
        return len(self.geometry)

    def slice(self, start: int, stop: int) -> "VectorTable":
        idx = list(range(start, min(stop, len(self))))
        return VectorTable(
            geometry=self.geometry.take(idx),
            columns={k: v[start:stop] for k, v in self.columns.items()},
        )


# ------------------------------------------------------------- shapefile

_SHP_NULL = 0
_SHP_POINT = 1
_SHP_POLYLINE = 3
_SHP_POLYGON = 5
_SHP_MULTIPOINT = 8
# Z/M variants share geometry layout with extra coordinate blocks
_SHP_Z = {11: 1, 13: 3, 15: 5, 18: 8, 21: 1, 23: 3, 25: 5, 28: 8}


def _read_shp(path: Path, srid: int) -> PackedGeometry:
    d = path.read_bytes()
    if len(d) < 100 or struct.unpack(">i", d[:4])[0] != 9994:
        raise ValueError(f"not a shapefile: {path}")
    b = GeometryBuilder()
    o = 100
    n = len(d)
    while o + 8 <= n:
        (_recno, clen) = struct.unpack(">ii", d[o : o + 8])
        o += 8
        rec = d[o : o + 2 * clen]
        o += 2 * clen
        if len(rec) < 4:
            break
        (stype,) = struct.unpack("<i", rec[:4])
        base = _SHP_Z.get(stype, stype)
        if stype == _SHP_NULL:
            b.add_geometry(GeometryType.POINT, [[np.zeros((0, 2))]], srid)
        elif base == _SHP_POINT:
            x, y = struct.unpack("<dd", rec[4:20])
            b.add_geometry(GeometryType.POINT, [[np.array([[x, y]])]], srid)
        elif base == _SHP_MULTIPOINT:
            (npts,) = struct.unpack("<i", rec[36:40])
            pts = np.frombuffer(rec, "<f8", 2 * npts, 40).reshape(-1, 2)
            b.add_geometry(
                GeometryType.MULTIPOINT, [[p[None, :]] for p in pts], srid
            )
        elif base in (_SHP_POLYLINE, _SHP_POLYGON):
            nparts, npts = struct.unpack("<ii", rec[36:44])
            parts = np.frombuffer(rec, "<i4", nparts, 44)
            pts = np.frombuffer(
                rec, "<f8", 2 * npts, 44 + 4 * nparts
            ).reshape(-1, 2)
            rings = [
                np.array(pts[parts[i] : (parts[i + 1] if i + 1 < nparts else npts)])
                for i in range(nparts)
            ]
            if base == _SHP_POLYLINE:
                b.add_geometry(
                    GeometryType.MULTILINESTRING if len(rings) > 1 else GeometryType.LINESTRING,
                    [[r] for r in rings],
                    srid,
                )
            else:
                _emit_shp_polygon(b, rings, srid)
        else:
            raise ValueError(f"unsupported shape type {stype}")
    return b.build()


def _emit_shp_polygon(b: GeometryBuilder, rings: list[np.ndarray], srid: int):
    """Shapefile polygons: CW rings are shells, CCW are holes; holes belong
    to the preceding shell (spec ordering). Drop the closing vertex."""
    from ..core.types import open_ring, ring_signed_area

    polys: list[list[np.ndarray]] = []
    for r in rings:
        xy, _ = open_ring(r)
        if xy.shape[0] < 3:
            continue
        if ring_signed_area(xy) <= 0 or not polys:  # CW in shp = shell
            polys.append([xy])
        else:
            polys[-1].append(xy)
    if not polys:
        b.add_geometry(GeometryType.POLYGON, [[np.zeros((0, 2))]], srid)
    elif len(polys) == 1:
        b.add_geometry(GeometryType.POLYGON, [polys[0]], srid)
    else:
        b.add_geometry(GeometryType.MULTIPOLYGON, polys, srid)


def _read_dbf(path: Path) -> dict[str, np.ndarray]:
    """dBASE III attribute table -> typed numpy columns (the OGR field
    type-coercion analog, `OGRFileFormat.scala:156-203`)."""
    if not path.exists():
        return {}
    d = path.read_bytes()
    if len(d) < 32:
        return {}
    nrec = struct.unpack("<I", d[4:8])[0]
    hdr_len, rec_len = struct.unpack("<HH", d[8:12])
    fields = []
    o = 32
    while o + 32 <= hdr_len - 1 and d[o] != 0x0D:
        raw = d[o : o + 32]
        name = raw[:11].split(b"\0")[0].decode("ascii", "replace")
        ftype = chr(raw[11])
        flen = raw[16]
        fdec = raw[17]
        fields.append((name, ftype, flen, fdec))
        o += 32
    cols: dict[str, list] = {f[0]: [] for f in fields}
    o = hdr_len
    for _ in range(nrec):
        if o + rec_len > len(d):
            break
        rec = d[o : o + rec_len]
        o += rec_len
        p = 1  # skip deletion flag
        for name, ftype, flen, fdec in fields:
            raw = rec[p : p + flen]
            p += flen
            s = raw.decode("latin-1").strip()
            if ftype in ("N", "F"):
                try:
                    cols[name].append(float(s) if (fdec or "." in s) else int(s))
                except ValueError:
                    cols[name].append(np.nan if (fdec or "." in s) else 0)
            elif ftype == "L":
                cols[name].append(s.upper() in ("T", "Y"))
            else:
                cols[name].append(s)
    out: dict[str, np.ndarray] = {}
    for name, ftype, flen, fdec in fields:
        vals = cols[name]
        if ftype in ("N", "F"):
            want_int = not fdec and ftype == "N"
            try:
                out[name] = np.asarray(
                    vals, dtype=np.int64 if want_int else np.float64
                )
            except (ValueError, OverflowError):
                # malformed cells fell back to NaN: keep the column as float
                out[name] = np.asarray(vals, dtype=np.float64)
        elif ftype == "L":
            out[name] = np.asarray(vals, dtype=bool)
        else:
            out[name] = np.asarray(vals, dtype=object)
    return out


def _read_prj_srid(path: Path) -> int:
    """srid from the .prj WKT — fully parsed when possible.

    `core.crs_wkt.register_prj_text` lowers the WKT1 tree to a PROJ
    string and registers it (declared EPSG code, or a stable synthetic
    code), so `st_transform` works for ANY projection family the CRS
    engine implements, not just a recognized-name allowlist. Malformed
    or exotic WKT falls back to the old substring heuristic."""
    if not path.exists():
        return 4326
    text = path.read_text(errors="replace")
    try:
        from ..core.crs_wkt import register_prj_text

        return register_prj_text(text)
    except Exception:  # lint: broad-except-ok (WKT registry miss falls back to the keyword heuristic)
        up = text.upper()
        if "OSGB" in up or "27700" in up:
            return 27700
        if "PSEUDO-MERCATOR" in up or "3857" in up:
            return 3857
        return 4326


def read_shapefile(path: str) -> VectorTable:
    """ESRI Shapefile (+ sidecar .dbf attributes, .prj CRS hint)."""
    p = Path(path)
    srid = _read_prj_srid(p.with_suffix(".prj"))
    geom = _read_shp(p, srid)
    cols = _read_dbf(p.with_suffix(".dbf"))
    cols = {k: v[: len(geom)] for k, v in cols.items()}
    return VectorTable(geometry=geom, columns=cols)


# --------------------------------------------------------------- geojson


def props_to_columns(props: "list[dict | None]") -> dict[str, np.ndarray]:
    """Feature properties -> typed columns: all-numeric keys become float
    arrays (None -> NaN), everything else an object array. Shared by the
    GeoJSON and TopoJSON readers so both type columns identically."""
    keys: list[str] = []
    for pr in props:
        for k in pr or {}:
            if k not in keys:
                keys.append(k)
    cols: dict[str, np.ndarray] = {}
    for k in keys:
        vals = [(pr or {}).get(k) for pr in props]
        if all(isinstance(v, (int, float, type(None))) and not isinstance(v, bool) for v in vals):
            cols[k] = np.asarray(
                [np.nan if v is None else float(v) for v in vals]
            )
        else:
            cols[k] = np.asarray(vals, dtype=object)
    return cols


def read_geojson(path_or_obj) -> VectorTable:
    """GeoJSON FeatureCollection -> VectorTable (properties as columns)."""
    geom, props = read_feature_collection(path_or_obj)
    return VectorTable(geometry=geom, columns=props_to_columns(props))


# ------------------------------------------------------------ CSV points


def read_points_csv(
    path: str,
    lon_col: str,
    lat_col: str,
    max_rows: "int | None" = None,
) -> VectorTable:
    """Point table from CSV (the NYC-taxi trips ingestion path)."""
    import csv

    lons: list[float] = []
    lats: list[float] = []
    with open(path, newline="") as f:
        rd = csv.DictReader(f)
        for i, row in enumerate(rd):
            if max_rows is not None and i >= max_rows:
                break
            try:
                lons.append(float(row[lon_col]))
                lats.append(float(row[lat_col]))
            except (ValueError, KeyError):
                lons.append(np.nan)
                lats.append(np.nan)
    from ..functions.formats import st_point

    geom = st_point(np.asarray(lons), np.asarray(lats))
    return VectorTable(
        geometry=geom,
        columns={lon_col: np.asarray(lons), lat_col: np.asarray(lats)},
    )


def read_wkt_csv(
    path: str,
    wkt_col: str = "wkt",
    srid: int = 4326,
    max_rows: "int | None" = None,
) -> VectorTable:
    """CSV with a WKT geometry column (OGR "CSV" driver semantics: the
    GEOM_POSSIBLE_NAMES field parses as WKT, other columns ride along)."""
    import csv

    from ..core.geometry.wkt import from_wkt

    wkts: list[str] = []
    rows: list[dict] = []
    with open(path, newline="") as f:
        rd = csv.DictReader(f)
        if rd.fieldnames is None or wkt_col not in rd.fieldnames:
            raise ValueError(
                f"no column {wkt_col!r} in {path}; have {rd.fieldnames}"
            )
        for i, row in enumerate(rd):
            if max_rows is not None and i >= max_rows:
                break
            wkts.append(row.pop(wkt_col) or "GEOMETRYCOLLECTION EMPTY")
            rows.append(row)
    geom = from_wkt(wkts, srid=srid)
    keys = rd.fieldnames or []
    cols = {
        k: np.asarray([r.get(k) for r in rows], dtype=object)
        for k in keys
        if k != wkt_col
    }
    return VectorTable(geometry=geom, columns=cols)


# ------------------------------------------------- multiread (chunked)


def multiread(
    paths: "list[str] | str",
    reader=None,
    chunk_size: int = 5000,
    workers: int = 8,
) -> VectorTable:
    """Parallel chunked reads: partition = file x chunk (reference:
    `OGRMultiReadDataFrameReader.load:25-77` computes
    partitionCount = 1 + featureCount/chunkSize). Thread pool stands in for
    Spark tasks; chunk tables are concatenated columnar."""
    from concurrent.futures import ThreadPoolExecutor

    if isinstance(paths, str):
        paths = [paths]
    if reader is None:
        reader = open_any

    def load(p):
        return reader(p)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        tables = list(ex.map(load, paths))
    # chunked re-partition of each table (parallelism seam for downstream)
    chunks: list[VectorTable] = []
    for t in tables:
        for s in range(0, max(len(t), 1), chunk_size):
            chunks.append(t.slice(s, s + chunk_size))
    return concat_tables(chunks)


def concat_tables(tables: "list[VectorTable]") -> VectorTable:
    tables = [t for t in tables if len(t)]
    if not tables:
        raise ValueError("no rows")
    b = GeometryBuilder()
    for t in tables:
        for g in range(len(t.geometry)):
            b.append_from(t.geometry, g)
    keys = {k for t in tables for k in t.columns}
    cols = {}
    for k in keys:
        parts = [
            t.columns.get(k, np.full(len(t), np.nan)) for t in tables
        ]
        try:
            cols[k] = np.concatenate(parts)
        except (TypeError, ValueError):
            cols[k] = np.concatenate([np.asarray(p, dtype=object) for p in parts])
    return VectorTable(geometry=b.build(), columns=cols)


def open_any(path: str) -> VectorTable:
    s = str(path).lower()
    if s.endswith(".shp"):
        return read_shapefile(path)
    if s.endswith((".json", ".geojson")):
        return read_geojson(path)
    if s.endswith(".kml"):
        from .kml import read_kml

        return read_kml(path)
    if s.endswith(".gml"):
        from .gml import read_gml

        return read_gml(path)
    if s.endswith(".gpx"):
        from .gml import read_gpx

        return read_gpx(path)
    if s.endswith(".mif"):
        from .mif import read_mif

        return read_mif(path)
    if s.endswith(".dxf"):
        from .dxf import read_dxf

        return read_dxf(path)
    if s.endswith(".gpkg"):
        from .geopackage import read_geopackage

        return read_geopackage(path)
    if s.endswith(".topojson"):
        from .topojson import read_topojson

        return read_topojson(path)
    if s.endswith(".fgb"):
        from .flatgeobuf import read_flatgeobuf

        return read_flatgeobuf(path)
    if s.endswith(".osm"):
        from .osm import read_osm

        return read_osm(path)
    if s.endswith((".geojsonl", ".ndjson", ".geojsons")):
        return read_geojson(path)  # newline-delimited handled natively
    raise ValueError(f"no reader for {path}")


# --------------------------------------------------------------- writers


def _feature_props(table: VectorTable, i: int) -> dict:
    """Row ``i``'s columns as JSON-safe properties (NaN -> null)."""
    props: dict = {}
    for k, col in table.columns.items():
        v = col[i]
        if isinstance(v, (np.floating, float)):
            props[k] = None if np.isnan(v) else float(v)
        elif isinstance(v, (np.integer, int)):
            props[k] = int(v)
        elif isinstance(v, (np.bool_, bool)):
            props[k] = bool(v)
        elif v is None:
            props[k] = None
        else:
            props[k] = str(v)
    return props


def write_geojson(path: str, table: VectorTable, seq: bool = False) -> None:
    """Write a :class:`VectorTable` as a GeoJSON FeatureCollection, or —
    with ``seq`` — as newline-delimited GeoJSONSeq (one feature per
    line, the OGR GeoJSONSeq driver's format). Round-trips through
    :func:`read_geojson` / ``read("geojsonseq")``.

    Reference analog: writing vector output through OGR drivers
    (`datasource/OGRFileFormat.scala:26-47`); the reference's write side
    goes through Spark writers, so this columnar writer is the native
    equivalent surface.
    """
    import json as _json

    from ..core.geometry.geojson import to_geojson_obj

    geoms = to_geojson_obj(table.geometry)
    feats = [
        {
            "type": "Feature",
            "geometry": g,
            "properties": _feature_props(table, i),
        }
        for i, g in enumerate(geoms)
    ]
    with open(path, "w") as f:
        if seq:
            for ft in feats:
                f.write(_json.dumps(ft) + "\n")
        else:
            _json.dump({"type": "FeatureCollection", "features": feats}, f)


def write_shapefile(path: str, table: VectorTable, srid: int = 4326) -> None:
    """Write a :class:`VectorTable` as an ESRI Shapefile (.shp/.shx/.dbf,
    plus a minimal .prj). One shape type per file (the format's rule):
    the type is taken from the first non-empty geometry; empties become
    NULL shapes. Rings are written in shapefile orientation (shells CW,
    holes CCW — the packed column stores the opposite, so each closed
    ring is emitted reversed). Round-trips through
    :func:`read_shapefile`.

    Reference analog: OGR's "ESRI Shapefile" driver on the write side
    (`datasource/OGRFileFormat.scala:26-47` names the driver; the
    reference writes through Spark/OGR, this is the native equivalent).
    """
    from ..core.types import GeometryType

    p = Path(path)
    col = table.geometry
    G = len(col)

    def base_type(g):
        gt = col.geometry_type(g).base
        if gt == GeometryType.POINT and col.geometry_type(g) == (
            GeometryType.MULTIPOINT
        ):
            return _SHP_MULTIPOINT
        return {
            GeometryType.POINT: _SHP_POINT,
            GeometryType.MULTIPOINT: _SHP_MULTIPOINT,
            GeometryType.LINESTRING: _SHP_POLYLINE,
            GeometryType.POLYGON: _SHP_POLYGON,
        }[gt]

    shape_type = _SHP_NULL
    for g in range(G):
        if col.geom_xy(g).shape[0]:
            t = base_type(g)
            if shape_type == _SHP_NULL:
                shape_type = t
            elif shape_type != t:
                raise ValueError(
                    "shapefiles hold ONE shape type; got both "
                    f"{shape_type} and {t}"
                )

    def rings_of(g):
        out = []
        for pt in col.geom_parts(g):
            for r in col.part_rings(pt):
                xy = col.ring_xy(r)
                if xy.shape[0]:
                    out.append(np.asarray(xy, dtype=np.float64))
        return out

    recs: list[bytes] = []
    for g in range(G):
        gt = col.geometry_type(g)
        xy = np.asarray(col.geom_xy(g), dtype=np.float64)
        if xy.shape[0] == 0:
            recs.append(struct.pack("<i", _SHP_NULL))
            continue
        if shape_type == _SHP_POINT:
            recs.append(struct.pack("<idd", 1, xy[0, 0], xy[0, 1]))
        elif shape_type == _SHP_MULTIPOINT:
            bb = (xy[:, 0].min(), xy[:, 1].min(), xy[:, 0].max(), xy[:, 1].max())
            recs.append(
                struct.pack("<i4di", 8, *bb, xy.shape[0]) + xy.tobytes()
            )
        else:
            rings = rings_of(g)
            if shape_type == _SHP_POLYGON and gt.base == GeometryType.POLYGON:
                # packed shells are CCW / holes CW; shp wants the reverse
                rings = [r[::-1] for r in rings]
            pts = np.concatenate(rings, axis=0)
            parts, off = [], 0
            for r in rings:
                parts.append(off)
                off += r.shape[0]
            bb = (
                pts[:, 0].min(), pts[:, 1].min(),
                pts[:, 0].max(), pts[:, 1].max(),
            )
            recs.append(
                struct.pack("<i4dii", shape_type, *bb, len(rings), off)
                + np.asarray(parts, "<i4").tobytes()
                + np.ascontiguousarray(pts).tobytes()
            )

    vb = [col.geom_xy(g) for g in range(G) if col.geom_xy(g).shape[0]]
    allv = np.concatenate(vb, axis=0) if vb else np.zeros((1, 2))
    bbox = (
        float(allv[:, 0].min()), float(allv[:, 1].min()),
        float(allv[:, 0].max()), float(allv[:, 1].max()),
    )

    def header(total_words: int) -> bytes:
        return (
            struct.pack(">i5i i", 9994, 0, 0, 0, 0, 0, total_words)
            + struct.pack("<ii", 1000, shape_type)
            + struct.pack("<4d", *bbox)
            + struct.pack("<4d", 0, 0, 0, 0)
        )

    shp = bytearray()
    shx = bytearray()
    off_words = 50
    for i, rec in enumerate(recs):
        clen = len(rec) // 2
        shp += struct.pack(">ii", i + 1, clen) + rec
        shx += struct.pack(">ii", off_words, clen)
        off_words += 4 + clen
    p.with_suffix(".shp").write_bytes(header(off_words) + shp)
    p.with_suffix(".shx").write_bytes(header(50 + 4 * G) + shx)

    # DBF: N for numerics, L for bools, C otherwise
    fields = []
    for k, v in table.columns.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            fields.append((k[:10], "N", 19, 7))
        elif np.issubdtype(a.dtype, np.integer):
            fields.append((k[:10], "N", 18, 0))
        elif a.dtype == bool:
            fields.append((k[:10], "L", 1, 0))
        else:
            w = max([1] + [len(str(x).encode("latin-1", "replace"))
                           for x in a])
            fields.append((k[:10], "C", min(254, w), 0))
    rec_len = 1 + sum(f[2] for f in fields)
    hdr_len = 33 + 32 * len(fields)
    dbf = bytearray(
        struct.pack("<BBBBIHH20x", 3, 26, 7, 31, G, hdr_len, rec_len)
    )
    for name, ft, fl, fd in fields:
        dbf += struct.pack(
            "<11sc4xBB14x", name.encode("ascii", "replace"), ft.encode(),
            fl, fd,
        )
    dbf += b"\x0d"
    names = list(table.columns)
    for g in range(G):
        dbf += b" "
        for (name, ft, fl, fd), k in zip(fields, names):
            v = table.columns[k][g]
            if ft == "N":
                s = (f"{v:.{fd}f}" if fd else str(int(v))) if not (
                    isinstance(v, float) and np.isnan(v)
                ) else ""
                dbf += s.rjust(fl)[:fl].encode("ascii", "replace")
            elif ft == "L":
                dbf += b"T" if v else b"F"
            else:
                dbf += str(v).encode("latin-1", "replace")[:fl].ljust(fl)
    dbf += b"\x1a"
    p.with_suffix(".dbf").write_bytes(dbf)

    prj = {
        4326: 'GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID'
              '["WGS_1984",6378137.0,298.257223563]],PRIMEM["Greenwich",0.0],'
              'UNIT["Degree",0.0174532925199433],'
              'AUTHORITY["EPSG","4326"]]',
        27700: 'PROJCS["British_National_Grid_OSGB",GEOGCS["GCS_OSGB_1936",'
               'DATUM["D_OSGB_1936",SPHEROID["Airy_1830",6377563.396,'
               '299.3249646]],PRIMEM["Greenwich",0.0],UNIT["Degree",'
               '0.0174532925199433]],PROJECTION["Transverse_Mercator"],'
               'PARAMETER["latitude_of_origin",49],'
               'PARAMETER["central_meridian",-2],'
               'PARAMETER["scale_factor",0.9996012717],'
               'PARAMETER["false_easting",400000],'
               'PARAMETER["false_northing",-100000],UNIT["metre",1],'
               'AUTHORITY["EPSG","27700"]]',
        3857: 'PROJCS["WGS_1984_Web_Mercator_Auxiliary_Sphere(Pseudo-Mercator)"'
              ',GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",SPHEROID["WGS_1984",'
              '6378137.0,298.257223563]],PRIMEM["Greenwich",0.0],'
              'UNIT["Degree",0.0174532925199433]],'
              'PROJECTION["Mercator_Auxiliary_Sphere"],'
              'UNIT["Meter",1.0],AUTHORITY["EPSG","3857"]]',
    }.get(srid)
    if prj:
        p.with_suffix(".prj").write_text(prj)
