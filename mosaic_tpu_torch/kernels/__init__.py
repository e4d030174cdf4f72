from . import pip, zonal

__all__ = ["pip", "zonal"]
