"""Input coercion + format preservation for the function DSL.

Port of ``mosaic_tpu/functions/_coerce.py``. The reference's expressions
accept geometry in any serialized form (WKT, WKB, HEX, GeoJSON, internal)
and geometry-returning expressions serialize the result back into the
*input's* form (`expressions/geometry/base/VectorExpression.scala:17-94`,
`codegen/format/ConvertToCodeGen.scala:42-73`). Every DSL function
funnels its inputs through :func:`coerce`, and geometry outputs go back
out through :func:`like_input`.
"""

from __future__ import annotations

import numpy as np

from ..core.types import PackedGeometry
from ..core.geometry import geojson as _geojson
from ..core.geometry import wkb as _wkb
from ..core.geometry import wkt as _wkt

FORMATS = ("packed", "wkt", "wkb", "hex", "geojson", "coords")


def detect_format(data) -> str:
    """Best-effort input form detection ('packed'|'wkt'|'wkb'|'hex'|'geojson')."""
    if isinstance(data, PackedGeometry):
        return "packed"
    if isinstance(data, np.ndarray):
        data = data.tolist()
    item = data
    if isinstance(data, (list, tuple)) and len(data):
        item = data[0]
    if isinstance(item, (bytes, bytearray, memoryview)):
        return "wkb"
    if isinstance(item, dict):
        return "geojson"
    if isinstance(item, str):
        s = item.lstrip()
        if s[:1] == "{":
            return "geojson"
        # hex WKB starts with the byte-order byte 00/01
        if s[:2] in ("00", "01") and all(
            c in "0123456789abcdefABCDEF" for c in s[:16]
        ):
            return "hex"
        return "wkt"
    raise TypeError(f"cannot interpret {type(item).__name__} as geometry")


def coerce(data, srid: int = 4326) -> tuple[PackedGeometry, str]:
    """Any geometry input -> (PackedGeometry, detected format)."""
    if isinstance(data, np.ndarray):
        data = data.tolist()
    fmt = detect_format(data)
    if fmt == "packed":
        return data, fmt
    single = not isinstance(data, (list, tuple))
    seq = [data] if single else list(data)
    if fmt == "wkt":
        return _wkt.from_wkt(seq, srid=srid), fmt
    if fmt == "wkb":
        return _wkb.from_wkb(seq, srid=srid), fmt
    if fmt == "hex":
        return _wkb.from_hex(seq, srid=srid), fmt
    return _geojson.from_geojson(seq), fmt


def to_packed(data, srid: int = 4326) -> PackedGeometry:
    return coerce(data, srid)[0]


def serialize(col: PackedGeometry, fmt: str):
    """PackedGeometry -> the named serialized form."""
    if fmt == "packed" or fmt == "coords":
        return col
    if fmt == "wkt":
        return _wkt.to_wkt(col)
    if fmt == "wkb":
        return _wkb.to_wkb(col)
    if fmt == "hex":
        return _wkb.to_hex(col)
    if fmt == "geojson":
        return _geojson.to_geojson(col)
    raise ValueError(f"unknown geometry format {fmt!r}")


def like_input(col: PackedGeometry, fmt: str):
    """Serialize a result the way the input came in (reference: serialise)."""
    return serialize(col, fmt)


def as_points(data) -> np.ndarray:
    """Point-geometry input (or a raw (N,2) array) -> (N,2) float64."""
    if isinstance(data, np.ndarray) and data.ndim == 2 and data.shape[1] == 2:
        return np.asarray(data, dtype=np.float64)
    if hasattr(data, "shape") and getattr(data, "ndim", 0) == 2:
        return np.asarray(data, dtype=np.float64)
    col = to_packed(data)
    out = np.full((len(col), 2), np.nan)
    for g in range(len(col)):
        pts = col.geom_xy(g)
        if pts.shape[0]:
            out[g] = pts[0]
    return out
