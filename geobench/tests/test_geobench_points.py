"""The traffic generator: sizes, seeds, and where the points fall."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from geobench import points, polygons

CONFIG = {"points_bbox": [-74.3, 40.4, -73.6, 41.0]}
ZONES = {"kind": "star_lattice", "nx": 3, "ny": 3, "verts": 64, "seed": 7,
         "bbox": [-74.3, 40.4, -73.6, 41.0]}


def make(kind, seed, n=50_000):
    polys = polygons.make(ZONES)
    return points.make(kind, CONFIG, polys, n, points.generator(seed, "cpu"), "cpu")


def test_uniform_counts_box_and_seed():
    a = make({"kind": "uniform"}, 2**31 + 5)
    b = make({"kind": "uniform"}, 2**31 + 5)
    c = make({"kind": "uniform"}, 2**31 + 6)
    assert a.shape == (50_000, 2) and a.dtype == torch.float64
    assert torch.equal(a, b) and not torch.equal(a, c)
    x0, y0, x1, y1 = CONFIG["points_bbox"]
    assert (a[:, 0] >= x0).all() and (a[:, 0] <= x1).all()
    assert (a[:, 1] >= y0).all() and (a[:, 1] <= y1).all()
    # uniform: each quarter of the box holds about a quarter
    q = ((a[:, 0] > (x0 + x1) / 2).long() * 2 + (a[:, 1] > (y0 + y1) / 2).long())
    assert (torch.bincount(q, minlength=4).double() / len(a) - 0.25).abs().max() < 0.01


def test_zone_edges_counts_seed_and_distance():
    sigma = 15.0
    a = make({"kind": "zone_edges", "sigma_m": sigma}, 2**32 + 1)
    b = make({"kind": "zone_edges", "sigma_m": sigma}, 2**32 + 1)
    assert a.shape == (50_000, 2) and torch.equal(a, b)
    # distance in metres to the nearest edge of any zone: |N(0, sigma)|,
    # whose median is 0.674 sigma
    edges, _ = polygons.make(ZONES).edges()
    p = a[:2000].numpy()
    lat = np.deg2rad(40.7)
    sx, sy = np.cos(lat) * points.M_PER_DEG, points.M_PER_DEG
    ax, ay = edges[:, 0] * sx, edges[:, 1] * sy
    ex, ey = (edges[:, 2] - edges[:, 0]) * sx, (edges[:, 3] - edges[:, 1]) * sy
    px, py = p[:, :1] * sx, p[:, 1:] * sy
    t = np.clip(((px - ax) * ex + (py - ay) * ey) / (ex * ex + ey * ey), 0, 1)
    d = np.hypot(px - ax - t * ex, py - ay - t * ey).min(1)
    assert 0.55 * sigma < np.median(d) < 0.8 * sigma


MIXES = sorted(glob.glob(os.path.join(os.path.dirname(points.__file__), "..", "traffic", "*.json")))


@pytest.mark.parametrize("mix", MIXES, ids=os.path.basename)
def test_every_mix_finds_its_points_kind_by_name(mix):
    spec = json.load(open(mix))["points"]
    a = make(spec, 2**31 + 9, n=1000)
    assert a.shape == (1000, 2) and a.dtype == torch.float64


def test_unknown_points_kind_is_refused():
    with pytest.raises(ValueError, match="no_such_kind"):
        make({"kind": "no_such_kind"}, 1, n=10)
