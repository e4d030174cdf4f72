"""Point sets where H3 cell assignment is hardest, as numpy (lng, lat)
degrees: shared by the CPU tests of the plain cell chain and the card's
tests of the H3 kernel (`tests/test_torch_h3_kernel_gpu.py`). Imports
numpy and the port only."""

import numpy as np

from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.core.index.h3 import hexmath as hm
from mosaic_tpu_torch.core.index.h3.tables import derive
from mosaic_tpu_torch.datasets import NYC_BBOX


def globe(n: int, seed: int) -> np.ndarray:
    """Uniform over the sphere."""
    rng = np.random.default_rng(seed)
    lng = rng.uniform(-180.0, 180.0, n)
    lat = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, n)))
    return np.stack([lng, lat], axis=1)


def nyc(n: int, seed: int) -> np.ndarray:
    """Uniform over NYC_BBOX."""
    rng = np.random.default_rng(seed)
    x0, y0, x1, y1 = NYC_BBOX
    return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], axis=1)


def _lnglat(v: np.ndarray) -> np.ndarray:
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    return np.stack([np.degrees(np.arctan2(v[..., 1], v[..., 0])),
                     np.degrees(np.arcsin(np.clip(v[..., 2], -1.0, 1.0)))], axis=-1)


def face_edges(n_each: int = 4000, seed: int = 11) -> np.ndarray:
    """Points along the 30 icosahedron edges, where two faces' dots tie,
    each moved by at most 1e-9 degrees."""
    fc = hm._FACE_CENTER_VEC3
    d = fc @ fc.T
    np.fill_diagonal(d, -2.0)
    adjacent = np.sort(d, axis=1)[:, -3:].min()  # a face's three neighbours
    rng = np.random.default_rng(seed)
    out = []
    for a in range(20):
        for b in range(a + 1, 20):
            if d[a, b] < adjacent - 1e-9:
                continue
            m = fc[a] + fc[b]
            m /= np.linalg.norm(m)
            w = np.cross(fc[a] - fc[b], m)
            w /= np.linalg.norm(w)
            t = rng.uniform(-0.7, 0.7, n_each)
            out.append(_lnglat(m[None] + t[:, None] * w[None]))
    assert len(out) == 30
    pts = np.concatenate(out)
    return pts + rng.uniform(-1e-9, 1e-9, pts.shape)


def pentagon_centers() -> np.ndarray:
    """(12, 2): the res-0 pentagons' centres, the icosahedron's vertices."""
    bcs = np.nonzero(np.asarray(derive().is_pentagon))[0]
    base = hm.pack(bcs, np.full((bcs.size, 15), 7), 0)
    return H3IndexSystem().cell_center(base)


def vertices(n_each: int = 2000, seed: int = 12) -> np.ndarray:
    """Points within 1e-9 degrees of each icosahedron vertex."""
    rng = np.random.default_rng(seed)
    c = pentagon_centers()
    return (c[:, None] + rng.uniform(-1e-9, 1e-9, (12, n_each, 2))).reshape(-1, 2)


def pentagons(n_each: int = 20000, seed: int = 13) -> np.ndarray:
    """The 12 pentagons' neighbourhoods, from 1e-9 to 3 degrees out."""
    rng = np.random.default_rng(seed)
    c = pentagon_centers()
    r = 10.0 ** rng.uniform(-9.0, np.log10(3.0), (12, n_each))
    a = rng.uniform(0.0, 2 * np.pi, (12, n_each))
    pts = c[:, None] + np.stack([r * np.cos(a), r * np.sin(a)], -1)
    pts[..., 1] = np.clip(pts[..., 1], -90.0, 90.0)
    pts[..., 0] = (pts[..., 0] + 180.0) % 360.0 - 180.0
    return pts.reshape(-1, 2)


def extremes() -> np.ndarray:
    """lng at and next to +-180, lat at and next to +-90, and zero."""
    lngs = [-180.0, -179.9999999, -1e-12, 0.0, 1e-12, 179.9999999, 180.0]
    lats = [-90.0, -89.9999999, -45.0, 0.0, 45.0, 89.9999999, 90.0]
    return np.array([[x, y] for x in lngs for y in lats])


def non_finite() -> np.ndarray:
    """Every pair of NaN, +-inf, zero, ordinary and huge coordinates."""
    vals = [np.nan, np.inf, -np.inf, 0.0, 40.7, -73.9, 1e30, -1e30]
    return np.array([[x, y] for x in vals for y in vals])
