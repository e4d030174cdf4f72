"""Datasource readers (the reference's FileFormat/multiread layer).

Port of ``mosaic_tpu/readers``: host numpy code,
kept as a copy so that the port never imports the JAX package.

Reference analogs: `datasource/OGRFileFormat.scala` (vector files ->
DataFrame), `datasource/GDALFileFormat.scala` (raster metadata datasource),
`datasource/multiread/OGRMultiReadDataFrameReader.scala` (parallel chunked
vector reads), `datasource/multiread/RasterAsGridReader.scala` (the full
raster->grid pipeline). `read(fmt)` mirrors `MosaicContext.read.format(...)`
(`functions/MosaicContext.scala:802`).
"""

from .registry import read, write  # noqa: F401
from .vector import (  # noqa: F401
    read_geojson,
    read_points_csv,
    read_shapefile,
    write_geojson,
    write_shapefile,
)
from .raster_grid import raster_to_grid, read_gdal_metadata  # noqa: F401
from .geopackage import read_geopackage, write_geopackage  # noqa: F401
from .filegdb import read_filegdb  # noqa: F401
from .grib2 import read_grib2  # noqa: F401
from .osm import read_osm  # noqa: F401
from .hdf5_lite import H5Lite, read_netcdf  # noqa: F401
from .zarr_store import ZarrStore, read_zarr  # noqa: F401

__all__ = [
    "read",
    "write",
    "read_geojson",
    "read_shapefile",
    "read_points_csv",
    "write_geojson",
    "write_shapefile",
    "read_geopackage",
    "write_geopackage",
    "read_filegdb",
    "read_grib2",
    "read_osm",
    "read_netcdf",
    "H5Lite",
    "read_zarr",
    "ZarrStore",
    "raster_to_grid",
    "read_gdal_metadata",
]
