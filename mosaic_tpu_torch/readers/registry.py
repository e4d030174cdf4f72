"""`read(fmt)` — the `MosaicContext.read.format(...)` analog.

Reference: `MosaicDataFrameReader` dispatching on format name
(`datasource/multiread/MosaicDataFrameReader.scala`), service-loader
registration of the six datasources (META-INF DataSourceRegister).
"""

from __future__ import annotations

from typing import Callable


class _Reader:
    def __init__(self, fmt: str):
        self.fmt = fmt
        self.options: dict = {}

    def option(self, key: str, value) -> "_Reader":
        self.options[key] = value
        return self

    def load(self, path, **kwargs):
        merged = {**self.options, **kwargs}
        return _FORMATS[self.fmt](path, **merged)


def _fmt_shapefile(path, **kw):
    from .vector import read_shapefile

    return read_shapefile(path)


def _fmt_geojson(path, **kw):
    from .vector import read_geojson

    return read_geojson(path)


def _fmt_multiread(path, **kw):
    from .vector import multiread

    return multiread(path, chunk_size=int(kw.get("chunkSize", 5000)))


def _fmt_gdal(path, **kw):
    from .raster_grid import read_gdal_metadata

    return read_gdal_metadata(path, ext=kw.get("extensions", ".TIF"))


def _fmt_raster_to_grid(path, **kw):
    from .raster_grid import raster_to_grid

    return raster_to_grid(
        path,
        resolution=int(kw.get("resolution", 0)),
        combiner=kw.get("combiner", "avg"),
        index=kw.get("index"),
        raster_srid=kw.get("rasterSrid"),
        tile_size=int(kw.get("retileSize", 512)),
        k_ring_interpolate=int(kw.get("kRingInterpolate", 0)),
        ext=kw.get("extensions", ".TIF"),
        device=kw.get("device"),
    )


def _fmt_csv_points(path, **kw):
    from .vector import read_points_csv

    mr = kw.get("maxRows")
    return read_points_csv(
        path,
        lon_col=kw.get("lonCol", "pickup_longitude"),
        lat_col=kw.get("latCol", "pickup_latitude"),
        max_rows=None if mr is None else int(mr),
    )


def _fmt_geopackage(path, **kw):
    from .geopackage import read_geopackage

    return read_geopackage(path, layer=kw.get("layer"))


def _fmt_geodb(path, **kw):
    from .filegdb import read_filegdb

    return read_filegdb(path, layer=kw.get("layer"))


def _fmt_grib(path, **kw):
    from .grib2 import read_grib2

    return read_grib2(path)


def _fmt_zarr(path, **kw):
    from .zarr_store import read_zarr

    return read_zarr(path, array=kw.get("array"))


def _fmt_netcdf(path, **kw):
    from .hdf5_lite import read_netcdf

    return read_netcdf(path, variable=kw.get("variable"))


def _fmt_kml(path, **kw):
    from .kml import read_kml

    return read_kml(path)


def _fmt_gml(path, **kw):
    from .gml import read_gml

    return read_gml(path, srid=int(kw.get("srid", 4326)))


def _fmt_mif(path, **kw):
    from .mif import read_mif

    return read_mif(path)


def _fmt_dxf(path, **kw):
    from .dxf import read_dxf

    return read_dxf(path)


def _fmt_gpx(path, **kw):
    from .gml import read_gpx

    return read_gpx(path)


def _fmt_topojson(path, **kw):
    from .topojson import read_topojson

    return read_topojson(path, layer=kw.get("layer"))


def _fmt_flatgeobuf(path, **kw):
    from .flatgeobuf import read_flatgeobuf

    return read_flatgeobuf(path)


def _fmt_csv_wkt(path, **kw):
    from .vector import read_wkt_csv

    mr = kw.get("maxRows")
    return read_wkt_csv(
        path,
        wkt_col=kw.get("wktCol", "wkt"),
        srid=int(kw.get("srid", 4326)),
        max_rows=None if mr is None else int(mr),
    )


def _fmt_osm(path, **kw):
    from .osm import read_osm

    return read_osm(path)


_FORMATS: dict[str, Callable] = {
    "kml": _fmt_kml,
    "gml": _fmt_gml,
    "gpx": _fmt_gpx,
    "shapefile": _fmt_shapefile,
    "geojson": _fmt_geojson,
    "geopackage": _fmt_geopackage,
    "geodb": _fmt_geodb,
    "multi_read_ogr": _fmt_multiread,
    "gdal": _fmt_gdal,
    "grib": _fmt_grib,
    "netcdf": _fmt_netcdf,
    "zarr": _fmt_zarr,
    "raster_to_grid": _fmt_raster_to_grid,
    "csv_points": _fmt_csv_points,
    "mapinfo": _fmt_mif,  # OGR "MapInfo File" driver name analog
    "mif": _fmt_mif,
    "dxf": _fmt_dxf,
    "topojson": _fmt_topojson,
    "csv_wkt": _fmt_csv_wkt,  # OGR "CSV" driver with a WKT geometry field
    "flatgeobuf": _fmt_flatgeobuf,
    "geojsonseq": _fmt_geojson,  # NDJSON / RFC 8142 both handled
    "osm": _fmt_osm,
}


def read(fmt: str) -> _Reader:
    """`read("raster_to_grid").option("resolution", 6).load(path)`."""
    if fmt not in _FORMATS:
        raise ValueError(f"unknown format {fmt!r}; have {sorted(_FORMATS)}")
    return _Reader(fmt)


# ----------------------------------------------------------------- write


class _Writer:
    """`write(fmt).option(...).save(path, table)` — the write-side mirror
    of :func:`read` (the reference writes through Spark's
    `df.write.format(...)` + OGR drivers; these are the native columnar
    writers)."""

    def __init__(self, fmt: str):
        self.fmt = fmt
        self.options: dict = {}

    def option(self, key: str, value) -> "_Writer":
        self.options[key] = value
        return self

    def save(self, path, table, **kwargs) -> None:
        merged = {**self.options, **kwargs}
        _WRITE_FORMATS[self.fmt](path, table, **merged)


def _wfmt_geojson(path, table, **kw):
    from .vector import write_geojson

    write_geojson(path, table, seq=bool(kw.get("seq", False)))


def _wfmt_geojsonseq(path, table, **kw):
    from .vector import write_geojson

    write_geojson(path, table, seq=True)


def _wfmt_shapefile(path, table, **kw):
    from .vector import write_shapefile

    write_shapefile(path, table, srid=int(kw.get("srid", 4326)))


def _wfmt_flatgeobuf(path, table, **kw):
    from .flatgeobuf import write_flatgeobuf

    write_flatgeobuf(
        path, table, name=kw.get("name", "layer"),
        srid=int(kw.get("srid", 4326)),
    )


def _wfmt_geopackage(path, table, **kw):
    from .geopackage import write_geopackage

    write_geopackage(path, table, **kw)


def _wfmt_kml(path, table, **kw):
    from .kml import write_kml

    write_kml(path, table, name_col=kw.get("name_col"))


_WRITE_FORMATS: dict[str, Callable] = {
    "geojson": _wfmt_geojson,
    "kml": _wfmt_kml,
    "geojsonseq": _wfmt_geojsonseq,
    "shapefile": _wfmt_shapefile,
    "flatgeobuf": _wfmt_flatgeobuf,
    "geopackage": _wfmt_geopackage,
}


def write(fmt: str) -> _Writer:
    """`write("shapefile").option("srid", 27700).save(path, table)`."""
    if fmt not in _WRITE_FORMATS:
        raise ValueError(
            f"unknown write format {fmt!r}; have {sorted(_WRITE_FORMATS)}"
        )
    return _Writer(fmt)
