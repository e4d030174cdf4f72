"""Dispatch layer of the port: the bucket ladder (the raster tile
planner's shape snap). The dispatch core and serving are later slices."""

from .bucket import BucketLadder

__all__ = ["BucketLadder"]
