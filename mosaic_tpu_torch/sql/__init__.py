"""SQL-level services of the port: the point-in-polygon join, the
streaming join over a resident ring and the durable raster scan."""

from .join import ChipIndex, build_chip_index, host_join, pip_join, pip_join_points
from .raster_stream import RasterScanResult, RasterStream
from .stream import (
    StreamJoin,
    StreamResult,
    generator_rate,
    hbm_peak,
    ring_from_generator,
    ring_from_host,
)

__all__ = [
    "ChipIndex",
    "RasterScanResult",
    "RasterStream",
    "StreamJoin",
    "StreamResult",
    "build_chip_index",
    "generator_rate",
    "hbm_peak",
    "host_join",
    "pip_join",
    "pip_join_points",
    "ring_from_generator",
    "ring_from_host",
]
