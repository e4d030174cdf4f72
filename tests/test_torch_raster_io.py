"""The port's raster file IO (`mosaic_tpu_torch/raster/core.py`
`read_raster`, `write_geotiff`, `Raster.save_checkpoint`) against the
reference's, on the CPU.

Both packages decode through the same native engine
(`native/src/tiff.cpp`, ctypes) and write with the same numpy/struct
writer, so everything here is compared exactly:
- the bytes a GeoTIFF writer puts on disk, for int16, uint8, float32 and
  float64 pixels, one or more bands, a number or NaN as nodata, north-up
  and rotated geotransforms, geographic and projected SRIDs;
- the raster each package decodes from the other's file: pixels by their
  bytes, the geotransform, SRID, nodata, page count and metadata;
- the tiled, deflate, predictor-2 MODIS-like file of `modis_fixture.py`;
- the decoder's typed failures (`RasterDecodeError` with the native rc).
"""

import math
from pathlib import Path

import numpy as np
import pytest

from mosaic_tpu.raster import Raster as RRaster
from mosaic_tpu.raster import read_raster as ref_read
from mosaic_tpu.raster import write_geotiff as ref_write
from mosaic_tpu.runtime.errors import RasterDecodeError as RefDecodeError
from mosaic_tpu_torch.raster import Raster, read_raster, write_geotiff
from mosaic_tpu_torch.runtime.errors import RasterDecodeError, is_transient
from modis_fixture import MODIS_PIXEL, write_modis_like

NORTH_UP = (-74.05, 0.001, 0.0, 40.9, 0.0, -0.001)
UTM = (583000.0, 30.0, 0.0, 4520000.0, 0.0, -30.0)
ROTATED = (10.0, 2.0, 0.5, 20.0, 0.25, -2.0)

CASES = {
    "int16": (np.int16, 1, -9999.0, NORTH_UP, 4326),
    "uint8": (np.uint8, 3, 0.0, UTM, 32618),
    "float32_nan": (np.float32, 2, math.nan, UTM, 32618),
    "float64": (np.float64, 1, -1.5, ROTATED, 27700),
    "float32_no_nodata": (np.float32, 1, None, NORTH_UP, 0),
}


def _data(dtype, bands, h=37, w=53, seed=4):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(max(info.min, -30000), min(info.max, 30000),
                            (bands, h, w)).astype(dtype)
    v = rng.normal(0.0, 1e3, (bands, h, w)).astype(dtype)
    v[:, ::7, ::5] = np.nan if dtype != np.float64 else -1.5
    return v


def _pair(case):
    dtype, bands, nodata, gt, srid = CASES[case]
    data = _data(dtype, bands)
    meta = '<GDALMetadata><Item name="SOURCE">test</Item></GDALMetadata>'
    kw = dict(gt=gt, srid=srid, nodata=nodata, meta_xml=meta)
    return Raster(data=data.copy(), **kw), RRaster(data=data.copy(), **kw)


def same_raster(a, b):
    assert a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
    assert a.data.tobytes() == b.data.tobytes()
    assert a.gt == b.gt and a.srid == b.srid and a.pages == b.pages
    assert (a.nodata is None) == (b.nodata is None)
    if a.nodata is not None:
        assert np.float64(a.nodata).tobytes() == np.float64(b.nodata).tobytes()
    assert a.meta_xml == b.meta_xml and a.metadata() == b.metadata()


@pytest.mark.parametrize("case", sorted(CASES))
def test_geotiff_bytes_equal_reference(case, tmp_path):
    port, ref = _pair(case)
    write_geotiff(str(tmp_path / "p.tif"), port)
    ref_write(str(tmp_path / "r.tif"), ref)
    assert (tmp_path / "p.tif").read_bytes() == (tmp_path / "r.tif").read_bytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_reads_the_others_file(case, tmp_path):
    port, ref = _pair(case)
    write_geotiff(str(tmp_path / "p.tif"), port)
    ref_write(str(tmp_path / "r.tif"), ref)
    mine, theirs = read_raster(str(tmp_path / "r.tif")), ref_read(str(tmp_path / "p.tif"))
    same_raster(mine, theirs)
    same_raster(mine, read_raster(str(tmp_path / "p.tif")))
    assert mine.data.tobytes() == port.data.tobytes() and mine.gt == port.gt
    m, rm = mine.band(1).mask, theirs.band(1).mask
    assert np.array_equal(m, rm)
    assert np.array_equal(mine.band(1).masked_values, theirs.band(1).masked_values,
                          equal_nan=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_checkpoint_equals_reference(case, tmp_path):
    port, ref = _pair(case)
    a = Path(port.save_checkpoint(str(tmp_path / "p" / "nested")))
    b = Path(ref.save_checkpoint(str(tmp_path / "r" / "nested")))
    assert a.name == b.name and a.read_bytes() == b.read_bytes()
    named = Path(port.save_checkpoint(str(tmp_path / "p"), name="x.tif"))
    assert named.name == "x.tif" and named.read_bytes() == a.read_bytes()


def test_modis_like_tiled_deflate_predictor_equals_reference(tmp_path):
    path = write_modis_like(str(tmp_path / "modis.tif"), width=600, height=520, tile=256)
    mine, theirs = read_raster(path), ref_read(path)
    same_raster(mine, theirs)
    assert mine.data.dtype == np.int16 and mine.nodata == 32767.0
    assert abs(mine.gt[1] - MODIS_PIXEL) < 1e-3
    valid = mine.band(1).mask.mean()
    assert 0.05 < valid < 0.2
    assert mine.metadata()["PRODUCT"] == "SYNTHETIC_MCD43A4"
    # the decoded pixels round-trip through the port's writer unchanged
    write_geotiff(str(tmp_path / "again.tif"), mine)
    same_raster(read_raster(str(tmp_path / "again.tif")),
                ref_read(str(tmp_path / "again.tif")))


@pytest.mark.parametrize("what", ["missing", "not_tiff", "truncated"])
def test_decode_errors_are_typed_as_the_reference(what, tmp_path):
    p = tmp_path / "bad.tif"
    if what == "not_tiff":
        p.write_bytes(b"hello, not a tiff" * 4)
    elif what == "truncated":
        write_geotiff(str(p), _pair("int16")[0])
        p.write_bytes(p.read_bytes()[:300])
    with pytest.raises(RasterDecodeError) as mine:
        read_raster(str(p))
    with pytest.raises(RefDecodeError) as theirs:
        ref_read(str(p))
    assert mine.value.rc == theirs.value.rc != 0
    assert str(mine.value) == str(theirs.value)
    assert isinstance(mine.value, ValueError) and not is_transient(mine.value)


def test_writer_refuses_what_the_reference_refuses(tmp_path):
    r = Raster(data=np.zeros((1, 2, 2), np.int64), gt=NORTH_UP, srid=4326)
    rr = RRaster(data=np.zeros((1, 2, 2), np.int64), gt=NORTH_UP, srid=4326)
    with pytest.raises(ValueError) as mine:
        write_geotiff(str(tmp_path / "a.tif"), r)
    with pytest.raises(ValueError) as theirs:
        ref_write(str(tmp_path / "b.tif"), rr)
    assert str(mine.value) == str(theirs.value)
