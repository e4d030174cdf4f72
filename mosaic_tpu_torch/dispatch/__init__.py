"""Dispatch layer of the port: the bucket ladder (the raster tile
planner's shape snap) and ``guarded_call``, the watchdog/retry/degradation
composition every device call of the join goes through. The rest of the
dispatch core and serving are later slices."""

from .bucket import BucketLadder
from .core import guarded_call

__all__ = ["BucketLadder", "guarded_call"]
