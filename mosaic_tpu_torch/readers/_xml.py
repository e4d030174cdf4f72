"""Namespace-agnostic XML helpers shared by the KML/GML/GPX readers."""

from __future__ import annotations


def local(tag) -> str:
    """Element local name ('{ns}Polygon' -> 'Polygon')."""
    return str(tag).rsplit("}", 1)[-1]


def find(el, name: str):
    """First descendant (or self) with the given local name."""
    for c in el.iter():
        if local(c.tag) == name:
            return c
    return None


def children(el, name: str):
    """Direct children with the given local name."""
    return [c for c in el if local(c.tag) == name]
