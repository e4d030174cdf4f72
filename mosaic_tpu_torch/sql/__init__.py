"""SQL-level services of the port: the point-in-polygon join, the
streaming join over a resident ring, the durable raster scan and the
polygon overlay join."""

from .join import ChipIndex, build_chip_index, host_join, pip_join, pip_join_points
from .overlay import (
    OverlayMeasures,
    OverlayPrep,
    candidate_pairs,
    intersects_join,
    overlay_join,
    overlay_measures,
    prepare_overlay,
    warmup_overlay,
)
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
    "OverlayMeasures",
    "OverlayPrep",
    "RasterScanResult",
    "RasterStream",
    "StreamJoin",
    "StreamResult",
    "build_chip_index",
    "candidate_pairs",
    "generator_rate",
    "hbm_peak",
    "host_join",
    "intersects_join",
    "overlay_join",
    "overlay_measures",
    "pip_join",
    "pip_join_points",
    "prepare_overlay",
    "ring_from_generator",
    "ring_from_host",
    "warmup_overlay",
]
