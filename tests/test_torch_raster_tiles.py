"""The raster model and the tile pipeline: the port against the JAX package.

The same numpy rasters go through both packages. Plans, staged tiles and
masks are equal exactly; the f64 pixel centers of `tile_centers` (torch,
on the tensor's device) are equal bit for bit to the reference's device
centers and to the port's own host `host_tile_centers`, skewed
geotransforms included. File IO is not ported: it raises a typed
`NotImplementedError`.
"""

import numpy as np
import pytest
import torch

from mosaic_tpu.dispatch.bucket import BucketLadder as RefLadder
from mosaic_tpu.raster import Raster as RefRaster
from mosaic_tpu.raster import tiles as RT
from mosaic_tpu_torch import DeviceUnavailable
from mosaic_tpu_torch.datasets import NYC_BBOX, synthetic_raster
from mosaic_tpu_torch.dispatch.bucket import BucketLadder
from mosaic_tpu_torch.raster import (
    Raster,
    assign_tile_cells,
    plan_tiles,
    read_raster,
    stack_tiles,
    tile_centers,
    write_geotiff,
)
from mosaic_tpu_torch.raster import tiles as TT
from mosaic_tpu_torch.raster.zonal import host_tile_centers

GT = (-74.05, 0.01, 0.0, 40.78, 0.0, -0.01)


def _mk(cls, bands=1, h=10, w=12, dtype=np.float32, nodata=-9.0, seed=3, gt=GT):
    rng = np.random.default_rng(seed)
    data = rng.uniform(1, 100, (bands, h, w)).astype(dtype)
    return cls(data=data, gt=gt, srid=4326, nodata=nodata)


def _both(**kw):
    return _mk(RefRaster, **kw), _mk(Raster, **kw)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 65536])
def test_bucket_ladder_equals_reference(n):
    for kw in ({}, {"min_bucket": 32, "max_bucket": 2048, "growth": 2},
               {"min_bucket": 8, "max_bucket": 100_000, "growth": 3}):
        ref, port = RefLadder(**kw), BucketLadder(**kw)
        assert port.buckets == ref.buckets
        if n <= ref.max_bucket:
            assert port.bucket_for(n) == ref.bucket_for(n)
        else:
            with pytest.raises(ValueError):
                port.bucket_for(n)
    with pytest.raises(ValueError):
        BucketLadder(min_bucket=0)


@pytest.mark.parametrize(
    "shape, tile",
    [((75, 90), (32, 32)), ((75, 90), (33, 100)), ((70, 70), (32, 32)),
     ((10, 12), None), ((300, 40), (5000, 1))],
)
def test_plan_tiles_equals_reference(shape, tile):
    ref, port = _both(h=shape[0], w=shape[1])
    a, b = plan_tiles(port, tile), RT.plan_tiles(ref, tile)
    assert (a.shape, a.requested, a.raster_shape, a.gt) == (
        b.shape, b.requested, b.raster_shape, b.gt)
    assert _same(a.origins, b.origins)
    assert (a.ntiles, a.pixels, a.padded_pixels) == (b.ntiles, b.pixels, b.padded_pixels)


@pytest.mark.parametrize(
    "kw",
    [dict(h=75, w=90), dict(h=75, w=90, dtype=np.float64, nodata=np.nan),
     dict(h=40, w=33, dtype=np.int16, nodata=None), dict(bands=3, h=50, w=70)],
    ids=["nodata", "nan_nodata", "int16", "band3"],
)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stack_tiles_equals_reference(kw, dtype):
    ref, port = _both(**kw)
    band = ref.num_bands
    if ref.nodata is not None:
        for r in (ref, port):
            r.data[band - 1, :3, :4] = r.nodata
            r.data[band - 1, 20:23, 7] = r.nodata
    plan = RT.plan_tiles(ref, (32, 32))
    want_v, want_m = RT.stack_tiles(ref, plan, band, dtype=dtype)
    got_v, got_m = stack_tiles(port, plan_tiles(port, (32, 32)), band, dtype=dtype)
    assert _same(got_v, want_v) and _same(got_m, want_m)
    assert not np.isnan(got_v).any()
    assert _same(port.band(band).mask, ref.band(band).mask)
    if kw.get("nodata", -9.0) is not None:
        assert got_m.sum() == port.band(band).mask.sum() < port.height * port.width


@pytest.mark.parametrize(
    "gt", [GT, (100.0, 2.0, 0.5, 50.0, -0.25, -3.0), (-0.5, 1.0, 0.0, 15.5, 0.0, -1.0)],
    ids=["north_up", "skewed", "integer_centers"],
)
def test_tile_centers_bit_identical(gt):
    ref, port = _both(h=75, w=90, gt=gt)
    plan = plan_tiles(port, (32, 32))
    for t in range(plan.ntiles):
        got = tile_centers(np.asarray(plan.gt), plan.origins[t],
                           th=32, tw=32, device="cpu")
        assert got.dtype == torch.float64 and got.shape == (32 * 32, 2)
        want = np.asarray(RT.tile_centers(np.asarray(plan.gt), plan.origins[t],
                                          th=32, tw=32))
        assert _same(got.numpy(), want)
        assert _same(host_tile_centers(plan, t), want)


def test_tile_centers_match_raster_to_world():
    _, port = _both(h=40, w=40)
    plan = plan_tiles(port, (32, 32))
    dev = tile_centers(np.asarray(plan.gt), plan.origins[3], th=32, tw=32, device="cpu")
    wx, wy = port.raster_to_world(32.5, 32.5)
    assert dev[0].tolist() == [wx, wy]


def test_assign_tile_cells_equals_reference():
    from mosaic_tpu.core.index import CustomIndexSystem as RefCustom, GridConf as RefConf
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf

    conf = (-180, 180, -90, 90, 2, 10.0, 10.0)
    ref, port = _both(h=75, w=90, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0))
    plan = plan_tiles(port, (32, 32))
    for t in range(plan.ntiles):
        got = assign_tile_cells(plan.gt, plan.origins[t], plan.shape,
                                CustomIndexSystem(GridConf(*conf)), 3, device="cpu")
        want = RT.assign_tile_cells(plan.gt, plan.origins[t], plan.shape,
                                    RefCustom(RefConf(*conf)), 3)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tile_knob(monkeypatch):
    monkeypatch.delenv("MOSAIC_RASTER_TILE", raising=False)
    assert TT.default_tile_shape() == TT.DEFAULT_TILE == RT.DEFAULT_TILE
    monkeypatch.setenv("MOSAIC_RASTER_TILE", "512x128")
    assert TT.default_tile_shape() == (512, 128)
    assert plan_tiles(_mk(Raster, h=75, w=90)).shape == (512, 128)
    for bad in ("banana", "0x64"):
        monkeypatch.setenv("MOSAIC_RASTER_TILE", bad)
        with pytest.raises(ValueError, match="MOSAIC_RASTER_TILE"):
            TT.default_tile_shape()


def test_raster_model_equals_reference():
    ref, port = _both(bands=2, h=17, w=23, gt=(100.0, 2.0, 0.5, 50.0, -0.25, -3.0))
    for r in (ref, port):
        r.meta_xml = ('<GDALMetadata><Item name="A">1</Item>'
                      '<Item name="DESCRIPTION" sample="1">red</Item></GDALMetadata>')
    assert (port.num_bands, port.height, port.width, port.memsize) == (
        ref.num_bands, ref.height, ref.width, ref.memsize)
    assert port.summary() == ref.summary()
    assert port.georeference() == ref.georeference()
    assert port.band_metadata(2) == ref.band_metadata(2)
    assert port.band(2).description == ref.band(2).description == "red"
    assert port.is_empty() == ref.is_empty() and not port.is_empty()
    for a, b in zip(port.pixel_centers(), ref.pixel_centers()):
        assert _same(a, b)
    x, y = ref.pixel_centers()
    for a, b in zip(port.world_to_raster(x, y), ref.world_to_raster(x, y)):
        assert _same(a, b)
    for b in (1, 2):
        for name in ("min", "max", "mean"):
            assert getattr(port.band(b), name)() == getattr(ref.band(b), name)()
        assert _same(port.band(b).masked_values, ref.band(b).masked_values)
    tiles, rtiles = port.retile(10, 7), ref.retile(10, 7)
    assert len(tiles) == len(rtiles)
    for a, b in zip(tiles, rtiles):
        assert a.gt == b.gt and _same(a.data, b.data)
    with pytest.raises(IndexError):
        port.band(3)


def test_file_io_raises_typed_not_implemented(tmp_path):
    r = _mk(Raster)
    for call in (lambda: read_raster(str(tmp_path / "x.tif")),
                 lambda: write_geotiff(str(tmp_path / "x.tif"), r),
                 lambda: r.save_checkpoint(str(tmp_path))):
        with pytest.raises(NotImplementedError, match="item 14"):
            call()


def test_synthetic_raster_shape_and_nodata():
    r = synthetic_raster(240, 180, seed=11)
    assert r.data.shape == (1, 180, 240) and r.data.dtype == np.int16
    xmin, ymin, xmax, ymax = NYC_BBOX
    x0, sx, rx, y0, ry, sy = r.gt
    assert (x0, y0, rx, ry) == (xmin, ymax, 0.0, 0.0)
    assert x0 + 240 * sx == pytest.approx(xmax) and y0 + 180 * sy == pytest.approx(ymin)
    m = r.band(1).mask
    assert 0.15 < 1 - m.mean() < 0.25  # about a fifth nodata
    v = r.band(1).values[m]
    assert v.min() >= 0 and v.max() <= 32000 and v.std() > 1000
    again = synthetic_raster(240, 180, seed=11)
    assert _same(again.data, r.data)
    assert not _same(synthetic_raster(240, 180, seed=12).data, r.data)


def test_tile_centers_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        tile_centers(np.asarray(GT), (0, 0), th=32, tw=32)
