"""A lattice of star-shaped zones over a box: the taxi-zone stand-in.

The arithmetic is ``mosaic_tpu_torch.datasets.synthetic_zones``'s, copied
so that the yardstick does not move with the program: zone (i, j) is
centred in its lattice cell, its vertices at sorted random angles and
jittered radii, so it may be concave, and neighbours overlap slightly.
"""

from __future__ import annotations

import numpy as np

from geobench.polygons import Polygons


def make(p: dict) -> Polygons:
    nx, ny, verts = int(p["nx"]), int(p["ny"]), int(p["verts"])
    jitter = float(p.get("jitter", 0.45))
    rng = np.random.default_rng(int(p["seed"]))
    xmin, ymin, xmax, ymax = p["bbox"]
    dx, dy = (xmax - xmin) / nx, (ymax - ymin) / ny
    polys = []
    for j in range(ny):
        for i in range(nx):
            cx = xmin + (i + 0.5) * dx
            cy = ymin + (j + 0.5) * dy
            ang = np.sort(rng.uniform(0.0, 2 * np.pi, verts))
            rad = 0.62 + jitter * rng.uniform(-0.5, 0.5, verts)
            polys.append([np.column_stack(
                [cx + rad * dx * np.cos(ang), cy + rad * dy * np.sin(ang)])])
    return Polygons.from_rings(polys)
