from . import geojson, measures, oracle, wkb, wkt
from .device import DeviceGeometry, pack_to_device, to_device

__all__ = [
    "DeviceGeometry",
    "geojson",
    "measures",
    "oracle",
    "pack_to_device",
    "to_device",
    "wkb",
    "wkt",
]
