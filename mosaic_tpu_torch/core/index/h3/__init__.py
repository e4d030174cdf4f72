from . import constants, core, hexmath, tables
from .index import H3IndexSystem

__all__ = ["H3IndexSystem", "constants", "core", "hexmath", "tables"]
