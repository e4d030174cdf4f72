"""Zonal statistics: the port's `ZonalEngine` against the JAX package's.

The cases are the reference's own (`tests/test_raster_zonal.py`): the
custom grid `CUSTOM(-180, 180, -90, 90, 2, 10, 10)` at resolution 3,
three zones (one with a hole) whose edges cross the 32x32 tile boundaries
and run exactly through pixel centers, and a 75x90 raster with nodata
speckle (a value, or NaN), without nodata, or integer-valued. Each
package tessellates and indexes the same zones itself.

- `zones` in the f64 fold lane and `grid` must equal the reference's
  results, the port's own f64 host oracles and the reference's oracles bit
  for bit (keys, counts, and the f64 bits of sum, min and max).
- `zones` in the f32 tiled lane must equal the reference's tiled lane and
  the fold lane exactly on integer-valued data, and the reference's tiled
  lane to ``rtol=1e-6`` of the zone's sum of |v| on float data.
- One H3 case on a small NYC raster, at resolution 9.

Everything runs with ``device="cpu"``; without CUDA the default device
raises `DeviceUnavailable`.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.datasets import synthetic_zones as ref_zones
from mosaic_tpu.raster import Raster as RefRaster
from mosaic_tpu.raster import zonal as RZ
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch import DeviceUnavailable
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.datasets import synthetic_raster, synthetic_zones
from mosaic_tpu_torch.kernels import zonal as TK
from mosaic_tpu_torch.raster import Raster
from mosaic_tpu_torch.raster import zonal as TZ
from mosaic_tpu_torch.sql import join as TJ

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
REF = RefCustom(RefConf(*CONF))
PORT = CustomIndexSystem(GridConf(*CONF))
RES = 3
TILE = (32, 32)
SUM_RTOL = 1e-6
ZONES = [
    "POLYGON ((6 -20, 50 -25, 70 10, 40 8, 6 8, 6 -20), "
    "(20 -10, 30 -10, 30 -2, 20 -2, 20 -10))",
    "POLYGON ((55 -50, 85 -50, 85 -20, 70 -35, 55 -20, 55 -50))",
    "POLYGON ((2 -55, 20 -55, 20 -40, 2 -40, 2 -55))",
]
#: the reference's `_mk_raster` cases: value nodata; NaN nodata with
#: centers on the x=6 / y=8 zone edges; no nodata (the hole); integer data
CASES = {
    "nodata": dict(),
    "nan_edges": dict(nodata=np.nan, seed=11),
    "hole": dict(nodata=None, seed=13),
    "integer": dict(integer=True, seed=23),
}


def _mk(cls, h=75, w=90, nodata=-9.0, seed=5, integer=False):
    """75x90 at (32, 32) tiles: a 3x3 grid, both axes padded; pixel
    centers at integer world coordinates (x = col, y = 15 - row)."""
    rng = np.random.default_rng(seed)
    if integer:
        data = rng.integers(0, 100, (1, h, w)).astype(np.float64)
    else:
        data = rng.uniform(0, 100, (1, h, w))
    speck = rng.random((h, w)) < 0.1
    if nodata is not None:
        data[0][speck] = nodata
    return cls(data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0), srid=0, nodata=nodata)


def _port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def _rows(r) -> dict:
    """{key: (count, sum, min, max)}, f64 bit patterns kept."""
    return {int(k): (int(c), float(s).hex(), float(a).hex(), float(b).hex())
            for k, c, s, a, b in zip(r.keys, r.count, r.sum, r.min, r.max)}


def assert_equal(got, want):
    assert got.keys.dtype == np.int64 and got.count.dtype == np.int64
    assert got.sum.dtype == got.min.dtype == got.max.dtype == np.float64
    assert _rows(got) == _rows(want)
    assert got.pixels == want.pixels and got.band == want.band


def assert_close_sums(got, want, raster):
    """Keys, counts, min and max exact; sums to SUM_RTOL of sum |v|."""
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.count, want.count)
    np.testing.assert_array_equal(got.min, want.min)
    np.testing.assert_array_equal(got.max, want.max)
    abs_sum = np.abs(raster.band(1).masked_values)
    bound = SUM_RTOL * np.nansum(abs_sum)  # over every zone: a loose cap
    assert (np.abs(got.sum - want.sum) <= bound).all()


@pytest.fixture(scope="module")
def ixs():
    col = wkt.from_wkt(ZONES)
    ref = RJ.build_chip_index(ref_tessellate(col, REF, RES, keep_core_geoms=False))
    port = TJ.build_chip_index(
        tessellate(_port_geometry(col), PORT, RES, keep_core_geoms=False), device="cpu"
    )
    return ref, port


@pytest.fixture(scope="module")
def ref_zones_fold(ixs):
    """{case: the reference's fold-lane zones result}, computed once."""
    eng = RZ.ZonalEngine(REF, RES, chip_index=ixs[0])  # one engine: one compile
    return {name: eng.zones(_mk(RefRaster, **kw), tile=TILE) for name, kw in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_zones_fold_equals_reference_and_oracles(ixs, ref_zones_fold, case):
    ref_ix, ix = ixs
    r = _mk(Raster, **CASES[case])
    before = TK.zonal_fold.launches
    got = TZ.zonal_zones(r, ix, PORT, RES, tile=TILE, device="cpu")
    assert TK.zonal_fold.launches == before
    assert_equal(got, ref_zones_fold[case])
    assert_equal(got, TZ.host_zonal_zones_oracle(r, ix, PORT, RES, tile=TILE))
    rr = _mk(RefRaster, **CASES[case])
    assert_equal(got, RZ.host_zonal_zones_oracle(rr, ref_ix, REF, RES, tile=TILE))
    assert len(got.keys) == 3 and got.pixels > 0


def test_zones_tiled_lane(ixs):
    ref_ix, ix = ixs
    eng = TZ.ZonalEngine(PORT, RES, chip_index=ix, lane="tiled", device="cpu")
    assert eng.lane == "tiled"
    for case in ("integer", "nodata"):
        r, rr = _mk(Raster, **CASES[case]), _mk(RefRaster, **CASES[case])
        got = eng.zones(r, tile=TILE)
        want = RZ.ZonalEngine(REF, RES, chip_index=ref_ix, lane="tiled").zones(rr, tile=TILE)
        if case == "integer":
            assert_equal(got, want)
            fold = TZ.ZonalEngine(PORT, RES, chip_index=ix, lane="fold", device="cpu")
            assert_equal(got, fold.zones(r, tile=TILE))
        else:
            assert_close_sums(got, want, r)


def test_zones_engine_reuse(ixs, ref_zones_fold):
    _, ix = ixs
    eng = TZ.ZonalEngine(PORT, RES, chip_index=ix, device="cpu")
    for case in ("hole", "nodata", "hole"):
        assert_equal(eng.zones(_mk(Raster, **CASES[case]), tile=TILE),
                     ref_zones_fold[case])


@pytest.fixture(scope="module")
def ref_grid_engine():
    return RZ.ZonalEngine(REF, RES)


@pytest.mark.parametrize("case", ["nodata", "nan_edges"])
def test_grid_equals_reference_and_oracles(ref_grid_engine, case):
    r, rr = _mk(Raster, **CASES[case]), _mk(RefRaster, **CASES[case])
    got = TZ.zonal_grid(r, RES, index_system=PORT, tile=TILE, device="cpu")
    assert_equal(got, ref_grid_engine.grid(rr, tile=TILE))
    assert_equal(got, TZ.host_zonal_grid_oracle(r, RES, PORT, tile=TILE))
    assert_equal(got, RZ.host_zonal_grid_oracle(rr, RES, REF, tile=TILE))
    assert got.pixels == int(r.band(1).mask.sum())
    assert np.isfinite(got.sum).all()


def test_grid_tile_shape_invariant_keys():
    r = _mk(Raster)
    a = TZ.zonal_grid(r, RES, index_system=PORT, tile=(32, 32), device="cpu")
    b = TZ.zonal_grid(r, RES, index_system=PORT, tile=(64, 128), device="cpu")
    for f in ("keys", "count", "min", "max"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.sum, b.sum, rtol=1e-12)
    st = a.stat("mean")
    assert st[int(a.keys[0])] == pytest.approx(a.sum[0] / a.count[0])
    assert a.stat("count") == {int(k): int(c) for k, c in zip(a.keys, a.count)}


def test_host_zone_partial_equals_reference(ixs):
    ref_ix, ix = ixs
    r = _mk(Raster, nodata=np.nan, seed=11)
    plan = TZ.plan_tiles(r, TILE)
    vals, mask = TZ.stack_tiles(r, plan, 1)
    for t in (0, 4):
        pts = TZ.host_tile_centers(plan, t)
        got = TZ.host_zone_partial(pts, vals[t].reshape(-1), mask[t].reshape(-1),
                                   ix.host, PORT, RES, 3)
        want = RZ.host_zone_partial(pts, vals[t].reshape(-1), mask[t].reshape(-1),
                                    ref_ix.host, REF, RES, 3)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_lane_knob(monkeypatch):
    monkeypatch.delenv("MOSAIC_RASTER_LANE", raising=False)
    assert TZ.resolve_zonal_lane("auto") == "fold"
    monkeypatch.setenv("MOSAIC_RASTER_LANE", "tiled")
    assert TZ.resolve_zonal_lane("auto") == "tiled"
    assert TZ.resolve_zonal_lane("fold") == "fold"  # explicit beats env
    assert TZ.ZonalEngine(PORT, RES, device="cpu").lane == "tiled"
    assert TZ.ZonalEngine(PORT, RES, lane="fold", device="cpu").lane == "fold"
    monkeypatch.setenv("MOSAIC_RASTER_LANE", "warp")
    with pytest.raises(ValueError, match="zonal lane"):
        TZ.resolve_zonal_lane("auto")


def test_unported_options_raise_typed(ixs):
    _, ix = ixs
    r = _mk(Raster)
    eng = TZ.ZonalEngine(PORT, RES, device="cpu")
    with pytest.raises(ValueError, match="chip_index"):
        eng.zones(r)
    # expressions are ported; a zones fold still needs the vector side
    from mosaic_tpu_torch import expr as E

    with pytest.raises(ValueError, match="chip_index"):
        eng.map(E.band(1).zonal(by="zones"), r)
    # mesh= is ported (it raised before): only a count or a Mesh is taken
    with pytest.raises(TypeError, match="mesh="):
        TZ.ZonalEngine(PORT, RES, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        TZ.zonal_grid(r, RES, device="cpu")


def test_entry_points_raise_without_cuda(ixs, monkeypatch):
    _, ix = ixs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = _mk(Raster)
    with pytest.raises(DeviceUnavailable):
        TZ.ZonalEngine(PORT, RES)
    with pytest.raises(DeviceUnavailable):
        TZ.zonal_grid(r, RES, index_system=PORT)
    with pytest.raises(DeviceUnavailable):
        TZ.zonal_zones(r, ix, PORT, RES)


# ------------------------------------------------------------ H3, NYC


H3_BBOX = (-74.0, 40.7, -73.97, 40.725)
H3_RES = 9


def test_h3_zones_and_grid_on_nyc_raster():
    """A 120x100 synthetic raster over a corner of NYC, four 64-vertex
    zones, H3 resolution 9, (64, 64) tiles."""
    ref_ix = RJ.build_chip_index(ref_tessellate(
        ref_zones(2, 2, bbox=H3_BBOX, verts=64), RefH3(), H3_RES, keep_core_geoms=False))
    ix = TJ.build_chip_index(tessellate(
        synthetic_zones(2, 2, bbox=H3_BBOX, verts=64), H3IndexSystem(), H3_RES,
        keep_core_geoms=False), device="cpu")
    r = synthetic_raster(120, 100, bbox=H3_BBOX, seed=3)
    rr = RefRaster(data=r.data.copy(), gt=r.gt, srid=r.srid, nodata=r.nodata)
    tile = (64, 64)
    got = TZ.zonal_zones(r, ix, H3IndexSystem(), H3_RES, tile=tile, device="cpu")
    assert_equal(got, RZ.zonal_zones(rr, ref_ix, RefH3(), H3_RES, tile=tile))
    assert_equal(got, TZ.host_zonal_zones_oracle(r, ix, H3IndexSystem(), H3_RES, tile=tile))
    assert len(got.keys) == 4
    grid = TZ.zonal_grid(r, H3_RES, index_system=H3IndexSystem(), tile=tile, device="cpu")
    assert_equal(grid, RZ.zonal_grid(rr, H3_RES, index_system=RefH3(), tile=tile))
    assert grid.pixels == int(r.band(1).mask.sum())
