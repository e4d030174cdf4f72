"""SQL-level services of the port: the point-in-polygon join."""

from .join import ChipIndex, build_chip_index, host_join, pip_join, pip_join_points

__all__ = ["ChipIndex", "build_chip_index", "host_join", "pip_join", "pip_join_points"]
