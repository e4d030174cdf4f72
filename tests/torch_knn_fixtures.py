"""Shared inputs of the port's KNN tests (`tests/test_torch_knn*.py`):
the reference's `tests/test_knn_serve.py` fixture (the custom grid at
resolution 3, seeded squares and L shapes), reference columns carried to
the port, and f64 bit views. numpy only."""

import numpy as np

from mosaic_tpu_torch.core import types as T

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
BBOX = (-25.0, -25.0, 35.0, 20.0)
RES = 3
ROWS = (8, 512)
PAIRS = (64, 4096)


def port(col) -> T.PackedGeometry:
    return T.PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


def bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    return a.view(np.int64)


def square_wkts(rng, n, side=(0.5, 1.5), bbox=BBOX):
    """The reference's `tests/test_knn_serve.py` candidates."""
    cx = rng.uniform(bbox[0], bbox[2], n)
    cy = rng.uniform(bbox[1], bbox[3], n)
    s = rng.uniform(*side, n)
    return [
        f"POLYGON(({x} {y}, {x + w} {y}, {x + w} {y + w},"
        f" {x} {y + w}, {x} {y}))"
        for x, y, w in zip(cx, cy, s)
    ], cx, cy


def l_shapes(rng, n):
    out = []
    for _ in range(n):
        x = float(rng.uniform(BBOX[0], BBOX[2] - 3))
        y = float(rng.uniform(BBOX[1], BBOX[3] - 3))
        out.append(
            f"POLYGON(({x} {y}, {x + 2} {y}, {x + 2} {y + 0.6},"
            f" {x + 0.6} {y + 0.6}, {x + 0.6} {y + 2}, {x} {y + 2}, {x} {y}))"
        )
    return out
