"""WKB (and hex-WKB) reader/writer to/from :class:`PackedGeometry`.

Port of ``mosaic_tpu/core/geometry/wkb.py``, line for line (a copy kept
in the port so that it never imports the JAX package).

Reference analog: JTS `WKBReader`/`WKBWriter` used throughout the reference's
serialization (`core/geometry/MosaicGeometryJTS.scala`,
`core/types/model/MosaicChip.scala:61-66`). Supports 2D/Z coordinates, both
byte orders on read (writes little-endian), and EWKB SRID flags.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from ..types import GeometryBuilder, GeometryType, PackedGeometry, close_ring, open_ring

_WKB_Z = 0x80000000
_WKB_M = 0x40000000
_WKB_SRID = 0x20000000
_ISO_Z = 1000
_ISO_M = 2000


class _Reader:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def byte(self) -> int:
        b = self.buf[self.i]
        self.i += 1
        return b

    def u32(self, bo: str) -> int:
        v = struct.unpack_from(bo + "I", self.buf, self.i)[0]
        self.i += 4
        return v

    def coords(self, bo: str, n: int, dims: int) -> np.ndarray:
        dt = np.dtype(np.float64).newbyteorder("<" if bo == "<" else ">")
        arr = np.frombuffer(self.buf, dtype=dt, count=n * dims, offset=self.i)
        self.i += 8 * n * dims
        return arr.astype(np.float64).reshape(n, dims)


def _read_header(r: _Reader) -> tuple[str, GeometryType, int, int]:
    bo = "<" if r.byte() == 1 else ">"
    code = r.u32(bo)
    srid = 0
    has_z = bool(code & _WKB_Z)
    has_m = bool(code & _WKB_M)
    if code & _WKB_SRID:
        srid = r.u32(bo)
    code &= 0x0FFFFFFF
    if code >= _ISO_M:
        has_m = True
        code -= _ISO_M
    if code >= _ISO_Z:
        has_z = True
        code -= _ISO_Z
    dims = 2 + (1 if has_z else 0) + (1 if has_m else 0)
    return bo, GeometryType(code), srid, dims, has_z


def _split_xyz(pts: np.ndarray, has_z: bool = True) -> tuple[np.ndarray, np.ndarray | None]:
    """Split packed coord tuples; the third column is z only when the header
    had the Z flag (an XYM third column is a measure and is discarded)."""
    xy = np.ascontiguousarray(pts[:, :2])
    z = pts[:, 2].copy() if (pts.shape[1] >= 3 and has_z) else None
    return xy, z


def _append_wkb(
    builder: GeometryBuilder, r: _Reader, default_srid: int
) -> GeometryType:
    """Parse one WKB geometry; returns the DECLARED type (a collection
    resolves per the reference's first-polygonal semantics)."""
    bo, gtype, srid, dims, has_z = _read_header(r)
    srid = srid or default_srid

    def read_linear() -> tuple[np.ndarray, np.ndarray | None]:
        n = r.u32(bo)
        return _split_xyz(r.coords(bo, n, dims), has_z)

    def read_ring() -> tuple[np.ndarray, np.ndarray | None]:
        return open_ring(*read_linear())

    if gtype == GeometryType.POINT:
        xy, z = _split_xyz(r.coords(bo, 1, dims), has_z)
        if np.all(np.isnan(xy)):  # empty point encoding
            builder.end_part()
        else:
            builder.add_ring(xy, z)
            builder.end_part()
    elif gtype == GeometryType.LINESTRING:
        xy, z = read_linear()
        builder.add_ring(xy, z)
        builder.end_part()
    elif gtype == GeometryType.POLYGON:
        nrings = r.u32(bo)
        for _ in range(nrings):
            xy, z = read_ring()
            builder.add_ring(xy, z)
        builder.end_part()
    elif gtype in (
        GeometryType.MULTIPOINT,
        GeometryType.MULTILINESTRING,
        GeometryType.MULTIPOLYGON,
    ):
        nparts = r.u32(bo)
        for _ in range(nparts):
            sbo, sgt, _, sdims, s_has_z = _read_header(r)
            if sgt == GeometryType.POINT:
                xy, z = _split_xyz(r.coords(sbo, 1, sdims), s_has_z)
                builder.add_ring(xy, z)
                builder.end_part()
            elif sgt == GeometryType.LINESTRING:
                n = r.u32(sbo)
                xy, z = _split_xyz(r.coords(sbo, n, sdims), s_has_z)
                builder.add_ring(xy, z)
                builder.end_part()
            elif sgt == GeometryType.POLYGON:
                nrings = r.u32(sbo)
                for _ in range(nrings):
                    n = r.u32(sbo)
                    xy, z = open_ring(*_split_xyz(r.coords(sbo, n, sdims), s_has_z))
                    builder.add_ring(xy, z)
                builder.end_part()
            else:
                raise ValueError(f"invalid WKB: {sgt} inside {gtype}")
    elif gtype == GeometryType.GEOMETRYCOLLECTION:
        n = r.u32(bo)
        if n:  # reference first-polygonal semantics
            from .collection import end_collection

            members = []
            for _ in range(n):
                sub = GeometryBuilder()
                declared = _append_wkb(sub, r, srid)
                members.append((declared, sub.build()))
            end_collection(builder, members, srid)
            return gtype
        builder.end_part()
    else:
        raise NotImplementedError(f"WKB geometry type {gtype}")
    builder.end_geom(gtype, srid)
    return gtype


def from_wkb(blobs: Sequence[bytes] | bytes, srid: int = 4326) -> PackedGeometry:
    if isinstance(blobs, (bytes, bytearray)):
        blobs = [bytes(blobs)]
    builder = GeometryBuilder()
    for b in blobs:
        _append_wkb(builder, _Reader(bytes(b)), srid)
    return builder.build()


def from_hex(hexes: Sequence[str] | str, srid: int = 4326) -> PackedGeometry:
    if isinstance(hexes, str):
        hexes = [hexes]
    return from_wkb([bytes.fromhex(h) for h in hexes], srid)


def _write_coords(out: bytearray, xy: np.ndarray, z: np.ndarray | None, close: bool):
    pts, zz = (close_ring(xy, z) if close else (xy, z))
    out += struct.pack("<I", pts.shape[0])
    if zz is not None:
        interleaved = np.column_stack([pts, zz]).astype("<f8")
    else:
        interleaved = pts.astype("<f8")
    out += interleaved.tobytes()


def _geom_code(gt: GeometryType, has_z: bool) -> int:
    return int(gt) + (_ISO_Z if has_z else 0)


def to_wkb(col: PackedGeometry) -> list[bytes]:
    """Serialize each geometry to ISO WKB (little-endian)."""
    out: list[bytes] = []
    for g in range(len(col)):
        gt = col.geometry_type(g)
        has_z = col.has_z(g)
        buf = bytearray()
        buf += b"\x01"
        buf += struct.pack("<I", _geom_code(gt, has_z))
        parts = list(col.geom_parts(g))
        if gt == GeometryType.GEOMETRYCOLLECTION:
            # only empties are representable (null-geometry features)
            buf += struct.pack("<I", 0)
            out.append(bytes(buf))
            continue

        def ring_data(r):
            z = col.ring_z(r)
            return col.ring_xy(r), (z if has_z else None)

        if gt == GeometryType.POINT:
            rings = [r for p in parts for r in col.part_rings(p)]
            if not rings or col.ring_xy(rings[0]).shape[0] == 0:
                buf += struct.pack("<dd", np.nan, np.nan)
            else:
                xy, z = ring_data(rings[0])
                vals = [xy[0, 0], xy[0, 1]] + ([z[0]] if z is not None else [])
                buf += struct.pack("<%dd" % len(vals), *vals)
        elif gt == GeometryType.LINESTRING:
            rings = [r for p in parts for r in col.part_rings(p)]
            xy, z = ring_data(rings[0]) if rings else (np.zeros((0, 2)), None)
            _write_coords(buf, xy, z, close=False)
        elif gt == GeometryType.POLYGON:
            rings = [r for p in parts for r in col.part_rings(p)]
            buf += struct.pack("<I", len(rings))
            for r in rings:
                xy, z = ring_data(r)
                _write_coords(buf, xy, z, close=True)
        else:
            sub_gt = gt.base
            buf += struct.pack("<I", len(parts))
            for p in parts:
                buf += b"\x01"
                buf += struct.pack("<I", _geom_code(sub_gt, has_z))
                rings = list(col.part_rings(p))
                if sub_gt == GeometryType.POINT:
                    xy, z = ring_data(rings[0])
                    vals = [xy[0, 0], xy[0, 1]] + ([z[0]] if z is not None else [])
                    buf += struct.pack("<%dd" % len(vals), *vals)
                elif sub_gt == GeometryType.LINESTRING:
                    xy, z = ring_data(rings[0])
                    _write_coords(buf, xy, z, close=False)
                else:
                    buf += struct.pack("<I", len(rings))
                    for r in rings:
                        xy, z = ring_data(r)
                        _write_coords(buf, xy, z, close=True)
        out.append(bytes(buf))
    return out


def to_hex(col: PackedGeometry) -> list[str]:
    return [b.hex().upper() for b in to_wkb(col)]
