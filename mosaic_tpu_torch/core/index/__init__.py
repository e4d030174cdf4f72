from .base import IndexSystem
from .h3 import H3IndexSystem

__all__ = ["H3IndexSystem", "IndexSystem"]
