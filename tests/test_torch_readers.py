"""The port's readers and writers (`mosaic_tpu_torch/readers`) against the
reference's, on the CPU.

- Every case of the reference's `tests/test_readers_formats.py` runs again
  against the port (`torch_reference_tests.port_of`), with the reference's
  own assertions; the cases that need the reference's `/root/reference`
  fixtures skip with the reference's own reason.
- Every writer (`readers.write(fmt)`: GeoJSON, GeoJSONSeq, shapefile,
  FlatGeobuf, GeoPackage, KML) puts the reference's bytes on disk, every
  sidecar included; each package reads the other's files into the same
  table (geometry buffers bit for bit, attribute columns exactly).
- `read("raster_to_grid")` gives the reference's dicts exactly, for every
  combiner across a tile seam, for a raster in UTM, and with
  `kRingInterpolate=1`: integer-valued pixels, so the fold's sums are
  exact in both packages.
Each package keeps its own CRS registry, and a `.prj` read registers its
code; every test here starts from empty registries in both.
"""

from pathlib import Path

import numpy as np
import pytest

import mosaic_tpu.readers as RR
from mosaic_tpu.core.geometry import wkt as RW
from mosaic_tpu.core.index import H3 as RH3
from mosaic_tpu.readers.vector import VectorTable as RTable
import mosaic_tpu_torch.readers as TR
from mosaic_tpu_torch.core.geometry import wkt as TW
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.raster import Raster, write_geotiff
from mosaic_tpu_torch.readers.vector import VectorTable
from torch_reference_tests import cases, fresh_registries, port_of  # noqa: F401

globals().update(cases(port_of("test_readers_formats.py")))

FIELDS = ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")


@pytest.fixture(autouse=True)
def _fresh(fresh_registries):
    """Every test starts from empty CRS registries in both packages."""


def same_table(a, b):
    assert len(a) == len(b)
    for f in FIELDS:
        x, y = np.asarray(getattr(a.geometry, f)), np.asarray(getattr(b.geometry, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (a.geometry.z is None) == (b.geometry.z is None)
    if a.geometry.z is not None:
        assert np.asarray(a.geometry.z).tobytes() == np.asarray(b.geometry.z).tobytes()
    assert list(a.columns) == list(b.columns)
    for k in a.columns:
        x, y = np.asarray(a.columns[k]), np.asarray(b.columns[k])
        assert x.dtype == y.dtype and x.tolist() == y.tolist(), k


POLYS = [
    "POLYGON ((-74.0 40.7, -73.9 40.7, -73.9 40.8, -74.0 40.8, -74.0 40.7), "
    "(-73.98 40.72, -73.98 40.74, -73.96 40.74, -73.98 40.72))",
    "MULTIPOLYGON (((-73.8 40.6, -73.7 40.6, -73.7 40.7, -73.8 40.6)), "
    "((-73.65 40.61, -73.6 40.61, -73.6 40.66, -73.65 40.61)))",
    "POLYGON ((-73.912345678901 40.812345678901, -73.8 40.81, -73.85 40.9, "
    "-73.912345678901 40.812345678901))",
]
MIXED = POLYS + ["POINT (-73.95 40.75)", "LINESTRING (-74 40.6, -73.9 40.65, -73.8 40.6)"]


def _tables(wkts, srid=4326):
    n = len(wkts)
    cols = lambda: {  # noqa: E731
        "v": np.linspace(-2.5, 7.25, n),
        "name": np.asarray([f"zone {i}" for i in range(n)], dtype=object),
        "i": np.arange(n, dtype=np.int64) * 3,
    }
    t, r = TW.from_wkt(wkts), RW.from_wkt(wkts)
    t.srid[:] = srid
    r.srid[:] = srid
    return VectorTable(geometry=t, columns=cols()), RTable(geometry=r, columns=cols())


WRITERS = {  # format -> (file name, shapes a format holds, options)
    "geojson": ("a.geojson", MIXED, {}),
    "geojsonseq": ("a.geojsonl", MIXED, {}),
    "shapefile": ("a.shp", POLYS, {"srid": 32618}),
    "flatgeobuf": ("a.fgb", MIXED, {"name": "zones"}),
    "geopackage": ("a.gpkg", MIXED, {"layer": "zones", "srid": 4326}),
    "kml": ("a.kml", MIXED, {"name_col": "name"}),
}


def test_format_names_equal_reference():
    from mosaic_tpu.readers import registry as RReg
    from mosaic_tpu_torch.readers import registry as TReg

    assert sorted(TReg._FORMATS) == sorted(RReg._FORMATS)
    assert sorted(TReg._WRITE_FORMATS) == sorted(RReg._WRITE_FORMATS) == sorted(WRITERS)
    public = lambda m: sorted(  # noqa: E731
        n for n in dir(m) if not n.startswith("_") and callable(getattr(m, n)))
    assert public(TR) == public(RR)
    for bad in (lambda m: m.read("nope"), lambda m: m.write("nope")):
        with pytest.raises(ValueError) as mine:
            bad(TR)
        with pytest.raises(ValueError) as theirs:
            bad(RR)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_writer_bytes_equal_reference(fmt, tmp_path):
    name, wkts, opts = WRITERS[fmt]
    t, r = _tables(wkts)
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    w, rw = TR.write(fmt), RR.write(fmt)
    for k, v in opts.items():
        w, rw = w.option(k, v), rw.option(k, v)
    w.save(str(tmp_path / "p" / name), t)
    rw.save(str(tmp_path / "r" / name), r)
    files = sorted(f.name for f in (tmp_path / "r").iterdir())
    assert files == sorted(f.name for f in (tmp_path / "p").iterdir())
    for f in files:
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "r" / f).read_bytes(), f


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_each_package_reads_the_others_file(fmt, tmp_path):
    name, wkts, opts = WRITERS[fmt]
    t, r = _tables(wkts)
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    TR.write(fmt).save(str(tmp_path / "p" / name), t, **opts)
    RR.write(fmt).save(str(tmp_path / "r" / name), r, **opts)
    mine = TR.read(fmt).load(str(tmp_path / "r" / name))
    theirs = RR.read(fmt).load(str(tmp_path / "p" / name))
    same_table(mine, theirs)
    same_table(mine, TR.read(fmt).load(str(tmp_path / "p" / name)))


#: WKT1 of EPSG:32618 as GDAL writes it (the writers emit a `.prj` only
#: for 4326, 27700 and 3857)
UTM18N_PRJ = (
    'PROJCS["WGS 84 / UTM zone 18N",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378137,298.257223563]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]],PROJECTION["Transverse_Mercator"],'
    'PARAMETER["latitude_of_origin",0],PARAMETER["central_meridian",-75],'
    'PARAMETER["scale_factor",0.9996],PARAMETER["false_easting",500000],'
    'PARAMETER["false_northing",0],UNIT["metre",1],AUTHORITY["EPSG","32618"]]'
)


def test_shapefile_prj_srid_and_transform_equal_reference(tmp_path):
    """UTM 18N zones through a shapefile and its `.prj`: the SRID comes
    back through `crs_wkt`, and the transform back to EPSG:4326 equals the
    reference's bit for bit and holds its round-trip band
    (`tests/test_crs_affine.py`, 2e-7 degrees)."""
    from mosaic_tpu.functions import geometry as RF
    from mosaic_tpu_torch.functions import geometry as TF

    t, r = _tables(POLYS)
    tu = VectorTable(geometry=TF.st_transform(t.geometry, 32618), columns=t.columns)
    ru = RTable(geometry=RF.st_transform(r.geometry, 32618), columns=r.columns)
    TR.write("shapefile").save(str(tmp_path / "p.shp"), tu, srid=32618)
    RR.write("shapefile").save(str(tmp_path / "r.shp"), ru, srid=32618)
    for name in ("p.prj", "r.prj"):
        assert not (tmp_path / name).exists()
        (tmp_path / name).write_text(UTM18N_PRJ)
    mine, theirs = TR.read("shapefile").load(str(tmp_path / "p.shp")), \
        RR.read("shapefile").load(str(tmp_path / "r.shp"))
    same_table(mine, theirs)
    assert set(mine.geometry.srid.tolist()) == {32618}
    back, rback = TF.st_transform(mine.geometry, 4326), RF.st_transform(theirs.geometry, 4326)
    assert back.xy.tobytes() == rback.xy.tobytes()
    # a shapefile stores shells clockwise: compare with the untransformed
    # zones after the same write and read
    TR.write("shapefile").save(str(tmp_path / "g.shp"), t)
    plain = TR.read("shapefile").load(str(tmp_path / "g.shp")).geometry
    assert np.abs(back.xy - plain.xy).max() < 2e-7


# ------------------------------------------------------------ raster -> grid

def _write_rasters(d: Path, srid: int, h=64, w=96):
    """A two-band GeoTIFF of integer-valued pixels over lower Manhattan, in
    EPSG:4326 or in UTM 18N metres, nodata 0. Its sides are multiples of
    the tile sizes used here, so the reference compiles one tile shape."""
    rng = np.random.default_rng(srid)
    data = rng.integers(0, 400, (2, h, w)).astype(np.int16)
    gt = ((-74.02, 0.0005, 0.0, 40.76, 0.0, -0.0005) if srid == 4326
          else (583000.0, 45.0, 0.0, 4513000.0, 0.0, -45.0))
    d.mkdir(exist_ok=True)
    write_geotiff(str(d / f"a{srid}.tif"), Raster(data=data, gt=gt, srid=srid, nodata=0.0))
    return str(d / f"a{srid}.tif")


COMBINERS = ("avg", "min", "max", "median", "count")


@pytest.mark.parametrize("combiner", COMBINERS)
def test_raster_to_grid_equals_reference(combiner, tmp_path):
    """Two 32x32 tiles (one merge across a tile seam; median runs on the
    whole raster). The reference's fold compiles per tile call, so the
    raster stays small."""
    path = _write_rasters(tmp_path, 4326, h=32, w=64)
    mine = TR.read("raster_to_grid").option("retileSize", 32).load(
        path, index=H3IndexSystem(), device="cpu", resolution=9, combiner=combiner)
    theirs = RR.read("raster_to_grid").option("retileSize", 32).load(
        path, index=RH3, resolution=9, combiner=combiner)
    assert mine == theirs
    assert sorted(mine) == [1, 2] and len(mine[1]) > 10


def test_raster_to_grid_in_utm_equals_reference(tmp_path):
    """A raster in UTM 18N metres: pixel centres go to EPSG:4326 through
    the host CRS lane before the cells."""
    path = _write_rasters(tmp_path, 32618, h=32, w=48)
    mine = TR.raster_to_grid(path, 9, "avg", index=H3IndexSystem(), device="cpu")
    theirs = RR.raster_to_grid(path, 9, "avg", index=RH3)
    assert mine == theirs and len(mine[1]) > 10


def test_raster_to_grid_k_ring_interpolate_equals_reference(tmp_path):
    path = _write_rasters(tmp_path, 4326, h=16, w=24)
    mine = TR.raster_to_grid(path, 9, "avg", index=H3IndexSystem(),
                             k_ring_interpolate=1, device="cpu")
    theirs = RR.raster_to_grid(path, 9, "avg", index=RH3, k_ring_interpolate=1)
    assert mine == theirs
    plain = TR.raster_to_grid(path, 9, "avg", index=H3IndexSystem(), device="cpu")
    assert set(mine[1]) > set(plain[1])


def test_raster_to_grid_directory_and_metadata_equal_reference(tmp_path):
    _write_rasters(tmp_path / "d", 4326, h=16, w=16)
    _write_rasters(tmp_path / "d", 32618, h=16, w=16)
    d = str(tmp_path / "d")
    assert TR.read("gdal").option("extensions", ".tif").load(d) == \
        RR.read("gdal").option("extensions", ".tif").load(d)
    mine = TR.raster_to_grid(d, 8, "count", index=H3IndexSystem(), ext=".tif",
                             device="cpu")
    assert mine == RR.raster_to_grid(d, 8, "count", index=RH3, ext=".tif")


def test_raster_to_grid_default_device_needs_cuda(tmp_path, monkeypatch):
    """No reader falls back to the CPU when the card was asked for."""
    import torch

    from mosaic_tpu_torch import DeviceUnavailable

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _write_rasters(tmp_path, 4326)
    with pytest.raises(DeviceUnavailable):
        TR.raster_to_grid(path, 9, "avg", index=H3IndexSystem())
