from . import h3, pip, zonal

__all__ = ["h3", "pip", "zonal"]
