from .device import DeviceGeometry, pack_to_device, to_device

__all__ = ["DeviceGeometry", "pack_to_device", "to_device"]
