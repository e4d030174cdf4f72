"""The plain reference against brute force: overlapping polygons, holes,
L-shapes and concave stars; and its low-precision control."""

import numpy as np
import pytest
import torch

from geobench.polygons import Polygons
from geobench.reference import pip as reference


def brute(polys, pts):
    """Smallest id of a containing polygon, else -1, one point and one
    ring at a time (even-odd over every ring of a polygon)."""
    out = np.full(len(pts), -1)
    for i, (x, y) in enumerate(pts):
        for g in range(len(polys)):
            inside = False
            for r in range(polys.geom_rings[g], polys.geom_rings[g + 1]):
                ring = polys.xy[polys.ring_offsets[r]:polys.ring_offsets[r + 1]]
                for k in range(len(ring)):
                    x1, y1 = ring[k]
                    x2, y2 = ring[(k + 1) % len(ring)]
                    if (y1 > y) != (y2 > y) and x < x1 + (y - y1) * (x2 - x1) / (y2 - y1):
                        inside = not inside
            if inside:
                out[i] = g
                break
    return out


def fixture():
    square = [[0, 0], [4, 0], [4, 4], [0, 4]]
    hole = [[1, 1], [1, 3], [3, 3], [3, 1]]
    ell = [[3, 3], [7, 3], [7, 5], [5, 5], [5, 7], [3, 7]]
    over = [[2, 2], [6, 2], [6, 6], [2, 6]]  # overlaps all three
    rng = np.random.default_rng(3)
    ang = np.sort(rng.uniform(0, 2 * np.pi, 40))
    rad = 1.5 + rng.uniform(-0.7, 0.7, 40)
    star = np.column_stack([8 + rad * np.cos(ang), 1 + rad * np.sin(ang)])
    return Polygons.from_rings([[square, hole], [ell], [over], [star]])


@pytest.mark.parametrize("block", [7, 1 << 25])
def test_reference_equals_brute_force(block, monkeypatch):
    polys = fixture()
    rng = np.random.default_rng(5)
    pts = rng.uniform([-1, -1], [10, 8], (3000, 2))
    monkeypatch.setattr(reference, "BLOCK_ELEMENTS", block * 40)
    got = reference.answers(polys, pts, "cpu").numpy()
    want = brute(polys, pts)
    assert (got == want).all()
    # every case is present: holes, overlaps taken by the smaller id, misses
    assert {-1, 0, 1, 2, 3} <= set(want.tolist())


def test_reference_on_the_configurations_polygons():
    from geobench import polygons

    polys = polygons.make({"kind": "star_lattice", "nx": 3, "ny": 2, "verts": 30, "seed": 7,
                           "bbox": [0, 0, 3, 2]})
    lo, hi = polys.xy.min(0), polys.xy.max(0)
    pts = np.random.default_rng(1).uniform(lo, hi, (2000, 2))
    assert (reference.answers(polys, pts, "cpu").numpy() == brute(polys, pts)).all()


def test_control_differs_and_only_by_precision():
    polys = fixture()
    pts = np.random.default_rng(9).uniform([-1, -1], [10, 8], (20000, 2)) + [-74.0, 40.7]
    moved = Polygons(polys.xy + [-74.0, 40.7], polys.ring_offsets, polys.geom_rings)
    want = reference.answers(moved, pts, "cpu")
    same = reference.answers(moved, pts, "cpu", dtype=torch.float64, shift=(-70.0, 44.7))
    low = reference.answers(moved, pts, "cpu", dtype=torch.bfloat16, shift=(-70.0, 44.7))
    assert (same == want).all()
    assert (low != want).double().mean() > 0.001
