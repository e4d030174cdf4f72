from .base import IndexSystem
from .bng import BNGIndexSystem
from .custom import CustomIndexSystem, GridConf, custom_from_name
from .h3 import H3IndexSystem

BNG = BNGIndexSystem()
H3 = H3IndexSystem()


def index_system_from_name(name: str) -> IndexSystem:
    """Factory (reference: `core/index/IndexSystemFactory.scala:3-26`)."""
    up = name.strip().upper()
    if up == "BNG":
        return BNG
    if up == "H3":
        return H3
    if up.startswith("CUSTOM"):
        return custom_from_name(name)
    raise ValueError(f"unknown index system {name!r}")


__all__ = [
    "BNG",
    "H3",
    "BNGIndexSystem",
    "CustomIndexSystem",
    "GridConf",
    "H3IndexSystem",
    "IndexSystem",
    "custom_from_name",
    "index_system_from_name",
]
