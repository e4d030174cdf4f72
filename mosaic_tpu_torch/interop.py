"""Arrow / pandas interop: the host-engine exchange boundary.

Port of ``mosaic_tpu/interop.py``: host numpy code,
kept as a copy so that the port never imports the JAX package.

Reference analog: the reference's language boundary is Spark rows — WKB
geometry columns plus attributes crossing the JVM↔Python py4j seam
(`python/mosaic/core/mosaic_context.py:58-60`), with Arrow as Spark's
columnar interchange for `mapInArrow` UDFs (SURVEY §7.6). Here the same
boundary is explicit: :class:`~.readers.vector.VectorTable` ⇄
``pyarrow.Table`` (geometry serialized as WKB or WKT) and a
``map_in_arrow`` adapter that wraps any VectorTable→VectorTable function
as a RecordBatch-iterator transform — exactly the contract
``DataFrame.mapInArrow`` expects, so the same callable plugs into a real
Spark session without this package importing Spark.

pyarrow/pandas are optional: importing this module without them raises
``ImportError`` at call time, not package-import time.
"""

from __future__ import annotations

import numpy as np

from .core.geometry import wkb as _wkb
from .core.geometry import wkt as _wkt
from .core.types import PackedGeometry


def _pa():
    import pyarrow

    return pyarrow


def _as_vector_table(obj) -> "object":
    from .readers.vector import VectorTable

    if isinstance(obj, VectorTable):
        return obj
    if isinstance(obj, PackedGeometry):
        return VectorTable(geometry=obj, columns={})
    raise TypeError(f"expected VectorTable or PackedGeometry, got {type(obj)}")


def to_arrow(obj, geometry_format: str = "wkb", geometry_col: str = "geometry"):
    """VectorTable / PackedGeometry -> ``pyarrow.Table``.

    The geometry column serializes to WKB (binary) or WKT (string);
    attribute columns pass through as Arrow arrays.
    """
    pa = _pa()
    vt = _as_vector_table(obj)
    if geometry_format == "wkb":
        geom = pa.array(_wkb.to_wkb(vt.geometry), type=pa.binary())
    elif geometry_format == "wkt":
        geom = pa.array(_wkt.to_wkt(vt.geometry), type=pa.string())
    else:
        raise ValueError(f"geometry_format must be wkb|wkt, got {geometry_format!r}")
    names = [geometry_col]
    arrays = [geom]
    for k, v in vt.columns.items():
        names.append(k)
        arrays.append(pa.array(v.tolist() if v.dtype == object else v))
    return pa.Table.from_arrays(arrays, names=names)


def from_arrow(table, geometry_col: "str | None" = None, srid: int = 4326):
    """``pyarrow.Table`` (or RecordBatch) -> VectorTable.

    ``geometry_col`` defaults to the first binary (WKB) or
    geometry-looking string (WKT) column.
    """
    pa = _pa()
    from .readers.vector import VectorTable

    if isinstance(table, pa.RecordBatch):
        table = pa.Table.from_batches([table])
    col = geometry_col
    if col is None:
        for name in table.column_names:
            t = table.column(name).type
            if pa.types.is_binary(t) or pa.types.is_large_binary(t):
                col = name
                break
            if (
                pa.types.is_string(t) or pa.types.is_large_string(t)
            ) and name.lower() in ("geometry", "geom", "wkt"):
                col = name
                break
        if col is None:
            raise ValueError(
                f"no geometry column found in {table.column_names}"
            )
    vals = table.column(col).to_pylist()
    if any(v is None for v in vals):
        raise ValueError(
            f"geometry column {col!r} contains nulls; filter or fill them "
            "before the interop boundary (e.g. WKB of POLYGON EMPTY)"
        )
    t = table.column(col).type
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        geom = _wkb.from_wkb([bytes(v) for v in vals], srid=srid)
    else:
        geom = _wkt.from_wkt([str(v) for v in vals], srid=srid)
    columns = {
        name: np.asarray(table.column(name).to_pylist())
        for name in table.column_names
        if name != col
    }
    return VectorTable(geometry=geom, columns=columns)


def map_in_arrow(
    fn, geometry_col: str = "geometry", geometry_format: str = "wkb",
    srid: int = 4326,
):
    """Wrap ``fn(VectorTable) -> VectorTable`` as a RecordBatch-iterator
    transform — directly usable as ``df.mapInArrow(map_in_arrow(fn),
    schema)`` on a Spark DataFrame, and testable standalone on any
    iterator of batches."""

    def _transform(batches):
        for batch in batches:
            vt = from_arrow(batch, geometry_col=geometry_col, srid=srid)
            out = _as_vector_table(fn(vt))
            yield from to_arrow(
                out, geometry_format=geometry_format,
                geometry_col=geometry_col,
            ).to_batches()

    return _transform


def to_pandas(obj, geometry_format: str = "wkt", geometry_col: str = "geometry"):
    """VectorTable / PackedGeometry -> pandas DataFrame (WKT default —
    readable; pass 'wkb' for lossless binary)."""
    return to_arrow(
        obj, geometry_format=geometry_format, geometry_col=geometry_col
    ).to_pandas()


def from_pandas(df, geometry_col: "str | None" = None, srid: int = 4326):
    """pandas DataFrame -> VectorTable (via Arrow)."""
    pa = _pa()
    return from_arrow(
        pa.Table.from_pandas(df, preserve_index=False),
        geometry_col=geometry_col,
        srid=srid,
    )
