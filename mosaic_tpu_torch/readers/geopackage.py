"""GeoPackage (OGC .gpkg) vector reader — stdlib sqlite3, no GDAL.

Reference analog: the OGR "GPKG" driver behind `OGRFileFormat`
(`datasource/OGRFileFormat.scala:26-473`): feature tables are discovered
through `gpkg_contents`/`gpkg_geometry_columns`, attribute columns become
typed arrays, and geometries are decoded from the GeoPackage geometry blob
(GP magic + envelope-flagged header, then standard WKB) into the packed
columnar layout.
"""

from __future__ import annotations

import sqlite3
import struct

import numpy as np

from ..core.geometry import wkb as _wkb
from .vector import VectorTable


def _parse_gpkg_blob(blob: bytes) -> tuple[bytes, int]:
    """GeoPackage geometry blob -> (wkb bytes, srid).

    Header: magic 'GP', version, flags (envelope size bits 1-3, empty bit
    4, byte-order bit 0), int32 srs_id, optional envelope of 0/32/48/64
    bytes, then WKB.
    """
    if len(blob) < 8 or blob[:2] != b"GP":
        raise ValueError("not a GeoPackage geometry blob")
    flags = blob[3]
    bo = "<" if (flags & 0x01) else ">"
    srid = struct.unpack(bo + "i", blob[4:8])[0]
    env_code = (flags >> 1) & 0x07
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}.get(env_code)
    if env_len is None:
        raise ValueError(f"invalid GeoPackage envelope code {env_code}")
    return blob[8 + env_len :], srid


def list_layers(path: str) -> list[str]:
    """Feature-table names declared in gpkg_contents."""
    con = sqlite3.connect(path)
    try:
        rows = con.execute(
            "SELECT table_name FROM gpkg_contents WHERE data_type='features'"
        ).fetchall()
        return [r[0] for r in rows]
    finally:
        con.close()


def read_geopackage(path: str, layer: str | None = None) -> VectorTable:
    """One feature table -> VectorTable (attributes as typed columns)."""
    con = sqlite3.connect(path)
    try:
        layers = [
            r[0]
            for r in con.execute(
                "SELECT table_name FROM gpkg_contents WHERE data_type='features'"
            )
        ]
        if not layers:
            raise ValueError(f"{path!r} declares no feature tables")
        if layer is None:
            layer = layers[0]
        elif layer not in layers:
            raise ValueError(f"layer {layer!r} not in {layers}")
        row = con.execute(
            "SELECT column_name, srs_id FROM gpkg_geometry_columns "
            "WHERE table_name=?",
            (layer,),
        ).fetchone()
        if row is None:
            raise ValueError(
                f"layer {layer!r} has no gpkg_geometry_columns entry"
            )
        geom_col, srid = row
        cols_info = con.execute(f'PRAGMA table_info("{layer}")').fetchall()
        attr_cols = [c[1] for c in cols_info if c[1] != geom_col]
        sel = ", ".join(f'"{c}"' for c in [geom_col, *attr_cols])
        rows = con.execute(f'SELECT {sel} FROM "{layer}"').fetchall()
    finally:
        con.close()
    # GeoPackage allows NULL geometries: keep row alignment by dropping
    # those rows from both the geometry column and the attributes
    rows = [r for r in rows if r[0] is not None]
    blobs = [_parse_gpkg_blob(r[0])[0] for r in rows]
    geom = _wkb.from_wkb(blobs, srid=int(srid) if srid and srid > 0 else 4326)
    columns: dict[str, np.ndarray] = {}
    for i, name in enumerate(attr_cols, start=1):
        vals = [r[i] for r in rows]
        if all(isinstance(v, (int, float, type(None))) for v in vals) and any(
            v is not None for v in vals
        ):
            columns[name] = np.asarray(
                [np.nan if v is None else float(v) for v in vals]
            )
        else:
            columns[name] = np.asarray(vals, dtype=object)
    return VectorTable(geometry=geom, columns=columns)


def write_geopackage(
    path: str, table: VectorTable, layer: str = "features", srid: int = 4326
) -> None:
    """Minimal writer (tests + interchange): one feature table."""
    con = sqlite3.connect(path)
    try:
        con.executescript(
            """
            CREATE TABLE gpkg_spatial_ref_sys (
              srs_name TEXT, srs_id INTEGER PRIMARY KEY, organization TEXT,
              organization_coordsys_id INTEGER, definition TEXT, description TEXT);
            CREATE TABLE gpkg_contents (
              table_name TEXT PRIMARY KEY, data_type TEXT, identifier TEXT,
              description TEXT, last_change TEXT, min_x REAL, min_y REAL,
              max_x REAL, max_y REAL, srs_id INTEGER);
            CREATE TABLE gpkg_geometry_columns (
              table_name TEXT PRIMARY KEY, column_name TEXT,
              geometry_type_name TEXT, srs_id INTEGER, z TINYINT, m TINYINT);
            """
        )
        con.execute(
            "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            (f"EPSG:{srid}", srid, "EPSG", srid, "", ""),
        )
        b = table.geometry.bounds()
        con.execute(
            "INSERT INTO gpkg_contents VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                layer,
                "features",
                layer,
                "",
                "",
                float(np.nanmin(b[:, 0])),
                float(np.nanmin(b[:, 1])),
                float(np.nanmax(b[:, 2])),
                float(np.nanmax(b[:, 3])),
                srid,
            ),
        )
        con.execute(
            "INSERT INTO gpkg_geometry_columns VALUES (?,?,?,?,?,?)",
            (layer, "geom", "GEOMETRY", srid, 0, 0),
        )
        names = list(table.columns)
        numeric = {
            c: np.issubdtype(np.asarray(table.columns[c]).dtype, np.number)
            for c in names
        }
        col_defs = "".join(
            f', "{c}" {"REAL" if numeric[c] else "TEXT"}' for c in names
        )
        con.execute(
            f'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY, geom BLOB{col_defs})'
        )
        blobs = _wkb.to_wkb(table.geometry)
        header = b"GP\x00\x01" + struct.pack("<i", srid)  # LE, no envelope
        ph = ",".join("?" * (2 + len(names)))
        for i, w in enumerate(blobs):
            vals = [
                float(table.columns[c][i])
                if numeric[c]
                else (
                    None
                    if table.columns[c][i] is None
                    else str(table.columns[c][i])
                )
                for c in names
            ]
            con.execute(
                f'INSERT INTO "{layer}" VALUES ({ph})', (i + 1, header + w, *vals)
            )
        con.commit()
    finally:
        con.close()
