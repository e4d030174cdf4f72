from .base import IndexSystem
from .custom import CustomIndexSystem, GridConf, custom_from_name
from .h3 import H3IndexSystem

__all__ = [
    "CustomIndexSystem",
    "GridConf",
    "H3IndexSystem",
    "IndexSystem",
    "custom_from_name",
]
