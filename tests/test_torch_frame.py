"""The port's `MosaicFrame` (`mosaic_tpu_torch/sql/frame.py`) against the
reference's (`mosaic_tpu/sql/frame.py`), on the CPU and on the same numpy
inputs. Both joins return integers and the frame's other outputs are host
values, so every comparison is exact: the point join's matched rows and
attribute columns (NaN and None masks included), the overlay join's
pairs, the chip tables of `set_index_resolution`, the analyzer's
resolution and the prettified text. The point join also equals the
port's own ``pip_join`` and, under the context's ``exact_recheck``,
``host_join``.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu import MosaicContext as RefContext
from mosaic_tpu.core.index import CustomIndexSystem as RCustom
from mosaic_tpu.core.index import GridConf as RConf
from mosaic_tpu.core.index.h3 import H3IndexSystem as RH3
from mosaic_tpu.datasets import synthetic_zones as ref_zones
from mosaic_tpu.sql.frame import MosaicFrame as RFrame
from mosaic_tpu_torch import context as TC
from mosaic_tpu_torch.convert import geometry_from_reference
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.sql.frame import MosaicFrame, _point_coords
from mosaic_tpu_torch.sql.join import host_join, pip_join

BBOX = (-74.0, 40.7, -73.9, 40.786)
RES = 9
CPU = "cpu"


@pytest.fixture(scope="module")
def data():
    zones = ref_zones(3, 3, bbox=BBOX, verts=32)
    rng = np.random.default_rng(17)
    pts = np.column_stack([rng.uniform(BBOX[0], BBOX[2], 3000),
                           rng.uniform(BBOX[1], BBOX[3], 3000)])
    ids = np.arange(len(zones)) * 10
    names = np.asarray([f"z{i}" for i in range(len(zones))])
    return zones, geometry_from_reference(zones), pts, ids, names


@pytest.fixture(scope="module")
def frames(data):
    zones, tzones, pts, ids, names = data
    from mosaic_tpu.core.types import PackedGeometry as RPacked

    ref = RFrame.from_geometry(zones, zone_id=ids, name=names)
    port = MosaicFrame.from_geometry(tzones, zone_id=ids, name=names)
    rpts = RFrame.from_geometry(RPacked.from_points(pts), pid=np.arange(len(pts)))
    tpts = MosaicFrame.from_geometry(PackedGeometry.from_points(pts), pid=np.arange(len(pts)))
    return ref, port, rpts, tpts


def _same_join(got, want):
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if b.dtype == object:
            assert a.tolist() == b.tolist(), k
        else:
            assert np.array_equal(a, b, equal_nan=b.dtype.kind == "f"), k


def test_point_in_polygon_join_equals_reference(frames):
    """Under the exact recheck both frames answer the exact f64 join, so
    every output column is equal. By default the reference's CPU join
    assigns cells in its f64 input dtype and the port's in float32, its
    device coordinate type: the rows differ only where those cells do."""
    ref, port, rpts, tpts = frames
    RefContext.build("H3", exact_recheck=True)
    TC.MosaicContext.build("H3", exact_recheck=True)
    try:
        want = ref.point_in_polygon_join(rpts, index=RH3(), resolution=RES)
        got = port.point_in_polygon_join(tpts, index=H3IndexSystem(), resolution=RES,
                                         device=CPU)
    finally:
        TC.MosaicContext.reset()
        RefContext.reset()
    _same_join(got, want)
    assert (got["polygon_row"] >= 0).any() and (got["polygon_row"] < 0).any()
    fast = port.point_in_polygon_join(tpts, index=H3IndexSystem(), resolution=RES,
                                      device=CPU)["polygon_row"]
    pts = np.stack([_point_coords(tpts.geometry, 0), _point_coords(tpts.geometry, 1)], -1)
    assert np.array_equal(fast, pip_join(pts, port.geometry, H3IndexSystem(), RES,
                                         probe="adaptive", device=CPU))
    diff = fast != got["polygon_row"]
    c32 = H3IndexSystem().point_to_cell(torch.from_numpy(pts).float(), RES).numpy()
    c64 = H3IndexSystem().point_to_cell(pts, RES)
    assert (c32[diff] != c64[diff]).all()


def test_indexed_frame_reuses_its_chips_and_joins_the_same(frames):
    ref, port, rpts, tpts = frames
    ridx = ref.set_index_resolution(RES, index=RH3())
    tidx = port.set_index_resolution(RES, index=H3IndexSystem())
    assert tidx.chips_index == ridx.chips_index == "H3" and tidx.resolution == RES
    assert np.array_equal(tidx.chips.cell_id, ridx.chips.cell_id)
    assert np.array_equal(tidx.chips.is_core, ridx.chips.is_core)
    assert tidx.chips.chips.xy.tobytes() == ridx.chips.chips.xy.tobytes()
    want = port.point_in_polygon_join(tpts, index=H3IndexSystem(), resolution=RES,
                                      device=CPU)
    got = tidx.point_in_polygon_join(tpts, index=H3IndexSystem(), device=CPU)
    _same_join(got, want)
    assert list(tidx._chip_indexes) == ["cpu"]  # built once from the chips
    ci = tidx._chip_indexes["cpu"]
    tidx.point_in_polygon_join(tpts, index=H3IndexSystem(), device=CPU)
    assert tidx._chip_indexes["cpu"] is ci
    assert port._chip_indexes == {}


def test_exact_recheck_context_equals_host_join(frames, data):
    _, port, _, tpts = frames
    pts = data[2]
    TC.MosaicContext.build("H3", exact_recheck=True)
    try:
        got = port.point_in_polygon_join(tpts, resolution=RES, device=CPU)["polygon_row"]
    finally:
        TC.MosaicContext.reset()
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql.join import build_chip_index

    table = tessellate(port.geometry, H3IndexSystem(), RES, keep_core_geoms=False)
    host = build_chip_index(table, device=CPU).host
    want = host_join(pts, host, H3IndexSystem(), RES)
    assert np.array_equal(got, want)


def test_context_index_and_analyzer_resolution_equal_reference(frames):
    ref, port, _, _ = frames
    RefContext.build("H3")
    TC.MosaicContext.build("H3")
    try:
        assert port.get_optimal_resolution() == ref.get_optimal_resolution()
        c = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
        rc = RCustom(RConf(-180, 180, -90, 90, 2, 10.0, 10.0))
        assert port.get_optimal_resolution(c) == ref.get_optimal_resolution(rc)
    finally:
        TC.MosaicContext.reset()
        RefContext.reset()


def test_intersects_join_equals_reference(data):
    zones, tzones, _, _, _ = data
    from mosaic_tpu.functions import st_translate as ref_translate
    from mosaic_tpu_torch.functions import st_translate

    rg, tg = RCustom(RConf(-180, 180, -90, 90, 2, 360, 180)), CustomIndexSystem(
        GridConf(-180, 180, -90, 90, 2, 360, 180))
    ref_a = RFrame.from_geometry(zones)
    ref_b = RFrame.from_geometry(ref_translate(zones, 0.013, 0.007))
    a = MosaicFrame.from_geometry(tzones)
    b = MosaicFrame.from_geometry(st_translate(tzones, 0.013, 0.007))
    want = ref_a.intersects_join(ref_b, index=rg, resolution=9)
    got = a.intersects_join(b, index=tg, resolution=9, device=CPU)
    assert got.dtype == want.dtype and np.array_equal(got, want) and len(want)
    # prebuilt chips on both sides give the same pairs
    ai = a.set_index_resolution(9, index=tg)
    bi = b.set_index_resolution(9, index=tg)
    assert np.array_equal(ai.intersects_join(bi, index=tg, device=CPU), want)


def test_prettified_and_from_table_equal_reference(frames, data):
    ref, port, _, _ = frames
    assert port.prettified(4) == ref.prettified(4)
    assert len(port) == len(ref)

    class Table:
        geometry = data[1]
        columns = {"zone_id": data[3]}

    t = MosaicFrame.from_table(Table)
    assert t.geometry is data[1] and list(t.columns) == ["zone_id"]


def test_point_coords_equal_the_reference_loop():
    from mosaic_tpu.sql.frame import _point_coords as ref_point_coords
    from mosaic_tpu.core.geometry import wkt as RW
    from mosaic_tpu_torch.core.geometry import wkt as TW

    wkts = ["POINT (1 2)", "POINT EMPTY", "LINESTRING (3 4, 5 6)",
            "POLYGON ((7 8, 9 8, 9 9, 7 8))", "MULTIPOINT ((1 5), (2 6))", "POLYGON EMPTY"]
    r, t = RW.from_wkt(wkts), TW.from_wkt(wkts)
    for axis in (0, 1):
        assert np.array_equal(_point_coords(t, axis), ref_point_coords(r, axis), equal_nan=True)
