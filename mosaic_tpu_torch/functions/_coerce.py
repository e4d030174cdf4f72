"""Input coercion of geometry columns.

Port of the part of ``mosaic_tpu/functions/_coerce.py`` that the tuning
profiler and the resolution analyzer read: :func:`detect_format`,
:func:`coerce` and :func:`to_packed`. A :class:`PackedGeometry` passes
through as it is. The serialized forms (WKT, WKB, hex WKB, GeoJSON) are
detected as the reference detects them, but their readers
(``core/geometry/{wkt,wkb,geojson}.py``) come with ROADMAP queue 1 item
14, so coercing one raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..core.types import PackedGeometry


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
    raise NotImplementedError(
        f"reading {fmt} geometry is not ported yet (ROADMAP queue 1, item "
        f"14: core/geometry/{{wkt,wkb,geojson}}.py); pass a PackedGeometry"
    )


def to_packed(data, srid: int = 4326) -> PackedGeometry:
    return coerce(data, srid)[0]
