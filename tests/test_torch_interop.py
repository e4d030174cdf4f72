"""The port's Arrow / pandas boundary (`mosaic_tpu_torch/interop.py`)
against the reference's, on the CPU.

Counterparts of every case of `tests/test_interop.py`, each run on both
packages over the same table: Arrow tables and pandas frames compare
equal, geometry buffers bit for bit, attribute columns exactly, and the
areas that the reference's cases check agree within their 1e-12 band
(the port's device measure runs on the CPU here). pyarrow and pandas are
optional, as in the reference: the file skips without pyarrow.
"""

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

from mosaic_tpu import functions as RF  # noqa: E402
from mosaic_tpu import interop as RI  # noqa: E402
from mosaic_tpu.core.geometry import wkb as RB  # noqa: E402
from mosaic_tpu.core.geometry import wkt as RW  # noqa: E402
from mosaic_tpu.core.index import H3 as RH3  # noqa: E402
from mosaic_tpu.readers.vector import VectorTable as RTable  # noqa: E402
from mosaic_tpu_torch import functions as TF  # noqa: E402
from mosaic_tpu_torch import interop as TI  # noqa: E402
from mosaic_tpu_torch.core.geometry import wkb as TB  # noqa: E402
from mosaic_tpu_torch.core.geometry import wkt as TW  # noqa: E402
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem  # noqa: E402
from mosaic_tpu_torch.readers.vector import VectorTable  # noqa: E402

FIELDS = ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")
WKTS = [
    "POLYGON ((-74.0 40.7, -73.9 40.7, -73.9 40.8, -74.0 40.8, -74.0 40.7), "
    "(-73.98 40.72, -73.98 40.74, -73.96 40.74, -73.98 40.72))",
    "MULTIPOLYGON (((-73.8 40.6, -73.7 40.6, -73.7 40.7, -73.8 40.6)), "
    "((-73.65 40.61, -73.6 40.61, -73.6 40.66, -73.65 40.61)))",
    "POINT (-73.95 40.75)",
    "LINESTRING (-74 40.6, -73.9 40.65, -73.8 40.6)",
] * 5


def _cols():
    n = len(WKTS)
    return {"name": np.asarray([f"z{i}" for i in range(n)], dtype=object),
            "v": np.linspace(0.5, 9.5, n)}


@pytest.fixture(scope="module")
def zones():
    return (VectorTable(geometry=TW.from_wkt(WKTS), columns=_cols()),
            RTable(geometry=RW.from_wkt(WKTS), columns=_cols()))


def same_table(a, b):
    assert len(a) == len(b)
    for f in FIELDS:
        x, y = np.asarray(getattr(a.geometry, f)), np.asarray(getattr(b.geometry, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert list(a.columns) == list(b.columns)
    for k in a.columns:
        assert np.asarray(a.columns[k]).tolist() == np.asarray(b.columns[k]).tolist(), k


@pytest.mark.parametrize("fmt", ["wkb", "wkt"])
def test_arrow_roundtrip(zones, fmt):
    t, r = zones
    tbl, rtbl = TI.to_arrow(t, geometry_format=fmt), RI.to_arrow(r, geometry_format=fmt)
    assert tbl.equals(rtbl) and tbl.schema == rtbl.schema
    back, rback = TI.from_arrow(tbl), RI.from_arrow(rtbl)
    same_table(back, rback)
    a0 = np.asarray(TF.st_area(t.geometry, device="cpu"))
    a1 = np.asarray(TF.st_area(back.geometry, device="cpu"))
    np.testing.assert_allclose(a0, a1, rtol=1e-12)
    np.testing.assert_allclose(a1, np.asarray(RF.st_area(rback.geometry)), rtol=1e-12)
    same_table(TI.from_arrow(rtbl), back)  # the reference's table, read by the port


def test_map_in_arrow_batch_pipeline(zones):
    def add_cells(F, index, table_cls, **kw):
        def fn(vt):
            _, off = F.grid_polyfill(vt.geometry, 7, index=index, **kw)
            cols = dict(vt.columns)
            cols["n_cells"] = np.diff(np.asarray(off))
            return table_cls(geometry=vt.geometry, columns=cols)
        return fn

    t, r = zones
    out = list(TI.map_in_arrow(add_cells(TF, H3IndexSystem(), VectorTable))(
        TI.to_arrow(t).to_batches(max_chunksize=8)))
    rout = list(RI.map_in_arrow(add_cells(RF, RH3, RTable))(
        RI.to_arrow(r).to_batches(max_chunksize=8)))
    assert len(out) == len(rout) > 1
    assert sum(b.num_rows for b in out) == len(t)
    merged, rmerged = pa.Table.from_batches(out), pa.Table.from_batches(rout)
    assert merged.equals(rmerged)
    n = np.asarray(merged.column("n_cells").to_pylist())
    assert (n >= 0).all() and n.sum() > 0


def test_pandas_roundtrip(zones):
    t, r = zones
    df, rdf = TI.to_pandas(t), RI.to_pandas(r)
    assert df.equals(rdf) and "geometry" in df.columns and len(df) == len(t)
    back, rback = TI.from_pandas(df), RI.from_pandas(rdf)
    same_table(back, rback)
    np.testing.assert_allclose(
        np.asarray(TF.st_area(t.geometry, device="cpu")),
        np.asarray(TF.st_area(back.geometry, device="cpu")),
        rtol=1e-12,
    )


def test_from_arrow_detects_geometry_column():
    g, rg = TW.from_wkt(["POINT (1 2)"]), RW.from_wkt(["POINT (1 2)"])
    tbl = pa.Table.from_arrays(
        [pa.array([7]), pa.array(TB.to_wkb(g), type=pa.binary())], names=["id", "blob"])
    rtbl = pa.Table.from_arrays(
        [pa.array([7]), pa.array(RB.to_wkb(rg), type=pa.binary())], names=["id", "blob"])
    assert tbl.equals(rtbl)
    vt, rvt = TI.from_arrow(tbl), RI.from_arrow(rtbl)
    same_table(vt, rvt)
    assert vt.geometry.geom_xy(0).tolist() == [[1.0, 2.0]]
    assert vt.columns["id"].tolist() == [7]
    bad = pa.Table.from_arrays([pa.array([1])], names=["x"])
    with pytest.raises(ValueError, match="no geometry column") as mine:
        TI.from_arrow(bad)
    with pytest.raises(ValueError) as theirs:
        RI.from_arrow(bad)
    assert str(mine.value) == str(theirs.value)
