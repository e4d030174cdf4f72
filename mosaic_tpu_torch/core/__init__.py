from .types import GeometryBuilder, GeometryType, PackedGeometry, PaddedGeometry

__all__ = ["GeometryBuilder", "GeometryType", "PackedGeometry", "PaddedGeometry"]
