"""Raster subsystem of the port: the dataset/band model, the tile
pipeline and zonal statistics (port of ``mosaic_tpu/raster``). Pixels
stay host numpy in band-sequential layout; tiles go to the device for
cell assignment, the zone probe and the fold. File IO is not ported yet:
:func:`read_raster` and :func:`write_geotiff` raise."""

from .core import Raster, RasterBand, read_raster, write_geotiff
from .tiles import (
    TilePlan,
    assign_tile_cells,
    default_tile_shape,
    plan_tiles,
    stack_tiles,
    tile_centers,
)
from .zonal import (
    ZonalEngine,
    ZonalResult,
    host_zonal_grid_oracle,
    host_zonal_zones_oracle,
    zonal_grid,
    zonal_zones,
)

__all__ = [
    "Raster",
    "RasterBand",
    "TilePlan",
    "ZonalEngine",
    "ZonalResult",
    "assign_tile_cells",
    "default_tile_shape",
    "host_zonal_grid_oracle",
    "host_zonal_zones_oracle",
    "plan_tiles",
    "read_raster",
    "stack_tiles",
    "tile_centers",
    "write_geotiff",
    "zonal_grid",
    "zonal_zones",
]
