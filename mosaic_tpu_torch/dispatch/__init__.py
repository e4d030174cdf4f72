"""Dispatch layer of the port: the bucket ladder (the raster tile
planner's shape snap), ``guarded_call`` (the watchdog/retry/degradation
composition every device call of the join goes through) and the
pipelined execution core of the durable stream and raster scan. The
rest of the dispatch core and serving are later slices."""

from .bucket import BucketLadder
from .core import guarded_call
from .pipeline import (
    DEFAULT_WINDOW,
    PipelineStats,
    SnapshotWriter,
    execute_pipeline,
    resolve_window,
)

__all__ = [
    "DEFAULT_WINDOW",
    "BucketLadder",
    "PipelineStats",
    "SnapshotWriter",
    "execute_pipeline",
    "guarded_call",
    "resolve_window",
]
