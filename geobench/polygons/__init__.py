"""Polygon sets of the configurations, made from a configuration's
``polygons`` entry by the generator its ``kind`` names
(``polygons/<kind>.py``, a ``make(params) -> Polygons`` function).

Numpy only: the reference reads these arrays, and the harness hands the
same arrays to the program.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from geobench.harness import load_module

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Polygons:
    """Polygons as flat rings: ring ``r`` is ``xy[ring_offsets[r]:
    ring_offsets[r + 1]]``, open (the last vertex joins the first);
    polygon ``g`` owns rings ``geom_rings[g]:geom_rings[g + 1]``, the
    first its shell, any others its holes. Polygon ids are row numbers."""

    xy: np.ndarray  # (V, 2) f64 lng, lat
    ring_offsets: np.ndarray  # (R + 1,) int64
    geom_rings: np.ndarray  # (G + 1,) int64

    def __len__(self) -> int:
        return len(self.geom_rings) - 1

    @classmethod
    def from_rings(cls, polys) -> "Polygons":
        """``polys``: a list of polygons, each a list of (n, 2) rings."""
        rings = [np.asarray(r, np.float64).reshape(-1, 2) for p in polys for r in p]
        sizes = np.array([len(r) for r in rings], np.int64)
        counts = np.array([len(p) for p in polys], np.int64)
        return cls(
            xy=np.concatenate(rings) if rings else np.zeros((0, 2)),
            ring_offsets=np.concatenate([[0], np.cumsum(sizes)]),
            geom_rings=np.concatenate([[0], np.cumsum(counts)]),
        )

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        """(edges (M, 4) x1, y1, x2, y2 of every ring, owner (M,) polygon
        id), ring by ring and polygon by polygon."""
        size = np.diff(self.ring_offsets)
        start = np.repeat(self.ring_offsets[:-1], size)
        i = np.arange(len(self.xy))
        nxt = start + (i - start + 1) % np.repeat(size, size)
        ring_owner = np.repeat(np.arange(len(self)), np.diff(self.geom_rings))
        return np.concatenate([self.xy, self.xy[nxt]], axis=1), np.repeat(ring_owner, size)

    def bounds(self) -> np.ndarray:
        """(G, 4) xmin, ymin, xmax, ymax of each polygon."""
        _, owner = self.edges()
        out = np.stack([np.full(len(self), np.inf)] * 2 + [np.full(len(self), -np.inf)] * 2, 1)
        for k, (f, col) in enumerate(((np.minimum, 0), (np.minimum, 1),
                                      (np.maximum, 0), (np.maximum, 1))):
            f.at(out[:, k], owner, self.xy[:, col])
        return out


def make(spec: dict) -> Polygons:
    """The polygons of a configuration's ``polygons`` entry."""
    path = os.path.join(HERE, f"{spec['kind']}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no polygon generator {spec['kind']!r} at {path}")
    mod = load_module(path, f"geobench_polygons_{spec['kind']}")
    return mod.make({k: v for k, v in spec.items() if k != "kind"})
