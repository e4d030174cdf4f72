from . import pip

__all__ = ["pip"]
