from .base import IndexSystem
from .bng import BNGIndexSystem
from .custom import CustomIndexSystem, GridConf, custom_from_name
from .h3 import H3IndexSystem

BNG = BNGIndexSystem()

__all__ = [
    "BNG",
    "BNGIndexSystem",
    "CustomIndexSystem",
    "GridConf",
    "H3IndexSystem",
    "IndexSystem",
    "custom_from_name",
]
