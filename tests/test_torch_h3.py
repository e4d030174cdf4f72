"""H3 cell assignment: the port against the JAX package.

- float64: the port's host path (numpy) and its device path (torch, on the
  CPU here) equal the reference's host and device paths exactly
  (tolerance 0), on global and NYC-bbox points at res 0, 5, 9 and 15;
- float32: the port's torch cells equal the reference's f32 cells outside
  the reference's own margin band (`point_to_cell_margin` below
  ``CELL_MARGIN_K·eps(f32)`` = 6·eps, `sql/join.py:91`). Inside the band
  the two may differ because torch's f32 trig is not XLA's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.datasets import NYC_BBOX

REF = RefH3()
PORT = H3IndexSystem()


def _points(region: str, n: int = 2000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if region == "global":
        lng = rng.uniform(-180.0, 180.0, n)
        lat = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, n)))
        return np.stack([lng, lat], axis=1)
    x0, y0, x1, y1 = NYC_BBOX
    return np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], axis=1)


@pytest.mark.parametrize("res", [0, 5, 9, 15])
@pytest.mark.parametrize("region", ["global", "nyc"])
def test_f64_cells_equal_reference(region, res):
    pts = _points(region, seed=res)
    want = REF.point_to_cell(pts, res)
    want_dev = np.asarray(REF.point_to_cell(jnp.asarray(pts), res))
    np.testing.assert_array_equal(want_dev, want)
    np.testing.assert_array_equal(PORT.point_to_cell(pts, res), want)
    got = PORT.point_to_cell(torch.as_tensor(pts), res)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("res", [0, 5, 9, 15])
@pytest.mark.parametrize("region", ["global", "nyc"])
def test_f32_cells_equal_reference_outside_margin_band(region, res):
    pts = _points(region, seed=100 + res).astype(np.float32)
    want, margin = REF.point_to_cell_margin(jnp.asarray(pts), res)
    want, margin = np.asarray(want), np.asarray(margin)
    got = PORT.point_to_cell(torch.as_tensor(pts), res).numpy()
    outside = margin[:, 0] >= 6.0 * float(np.finfo(np.float32).eps)
    # f32 lng/lat cannot resolve res-15 cells (~0.5 m): there the band
    # holds every point and nothing is claimed
    assert outside.mean() > (0.5 if res < 15 else -1.0)
    np.testing.assert_array_equal(got[outside], want[outside])


def test_host_helpers_equal_reference():
    """Boundaries, centers and polyfill candidates — the host methods
    tessellation calls — equal the reference's."""
    cells = REF.point_to_cell(_points("nyc", n=50, seed=3), 9)
    np.testing.assert_array_equal(
        PORT.cell_boundary(cells), REF.cell_boundary(cells)
    )
    np.testing.assert_array_equal(PORT.cell_center(cells), REF.cell_center(cells))
    bounds = np.asarray([[-74.0, 40.7, -73.99, 40.71], [-73.9, 40.6, -73.89, 40.62]])
    for a, b in zip(
        PORT.polyfill_candidates_batch(bounds, 9),
        REF.polyfill_candidates_batch(bounds, 9),
    ):
        np.testing.assert_array_equal(a, b)
