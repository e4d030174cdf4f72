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


def _pentagon_points(n_each: int = 150, seed: int = 7) -> np.ndarray:
    """Points within ~3 degrees of each of the 12 pentagon centers, where
    the device path's pentagon correction decides the digits."""
    from mosaic_tpu_torch.core.index.h3 import hexmath as hm
    from mosaic_tpu_torch.core.index.h3.tables import derive

    bcs = np.nonzero(np.asarray(derive().is_pentagon))[0]
    assert bcs.size == 12
    base = hm.pack(bcs, np.full((bcs.size, 15), 7), 0)
    centers = PORT.cell_center(base)  # (12, 2) lng, lat
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(-3.0, 3.0, (bcs.size, n_each, 2))
    pts = centers[:, None, :] + jitter
    pts[..., 1] = np.clip(pts[..., 1], -89.9, 89.9)
    pts[..., 0] = (pts[..., 0] + 180.0) % 360.0 - 180.0
    return pts.reshape(-1, 2)


@pytest.mark.parametrize("res", [1, 2, 5, 9, 14])
def test_pentagon_cells_equal_reference(res):
    """The device path's pentagon correction (one composed-rotation gather
    a row) equals the reference's host cells, primary and runner-up."""
    pts = _pentagon_points(seed=res)
    want = REF.point_to_cell(pts, res)
    got = PORT.point_to_cell(torch.as_tensor(pts), res)
    np.testing.assert_array_equal(got.numpy(), want)
    want_alt = PORT.point_to_cell_alt(pts, res)
    got_alt = PORT.point_to_cell_alt(torch.as_tensor(pts), res)
    np.testing.assert_array_equal(got_alt.numpy(), want_alt)


def test_warm_device_cells_copy_no_table(monkeypatch):
    """After one call, a cell assignment finds its constant tables on the
    device: no host array is copied there (on a card each such copy is a
    host sync), pentagon rows included."""
    pts = torch.as_tensor(np.concatenate([_pentagon_points(20), _points("nyc", 200)]))
    for dtype in (torch.float64, torch.float32):
        PORT.point_to_cell_margin(pts.to(dtype), 9)
        PORT.point_to_cell_alt(pts.to(dtype), 9)

    def refuse(*a, **k):
        raise AssertionError("a constant table was copied to the device again")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    for dtype in (torch.float64, torch.float32):
        PORT.point_to_cell_margin(pts.to(dtype), 9)
        PORT.point_to_cell_alt(pts.to(dtype), 9)


# ------------------------------------------- the first call of a process
#
# On the CPU, the first transcendental of a process (torch's MKL vector
# math: cos, sin, sqrt, atan, ...) can give wrong bits in whole thread
# chunks when it is split over the intra-op pool (3-8% of fresh
# processes, torch 2.13); `hexmath.warm_cpu_math` makes a one-element call
# first, once a process. Only a fresh interpreter shows the fault, so
# these tests start them (in parallel, each under its own timeout)
# through `mosaic_tpu_torch.tools.first_call_sweep`.


def test_first_cell_assignment_of_fresh_processes_is_right():
    """32 fresh interpreters with 32 intra-op threads each (where the
    fault is likeliest on this path): each one's FIRST `point_to_cell`
    (f32 tensor, the 161,354 seed-7 NYC points, res 9) equals its second,
    and its f64 tensor path equals the numpy host path."""
    from mosaic_tpu_torch.tools.first_call_sweep import sweep

    out = sweep(32, parallel=4, mode="cells", timeout_s=600.0, threads=32)
    assert out["differing"] == 0, out["rows_differing"]


def test_first_transcendental_of_fresh_processes_is_right():
    """64 fresh interpreters, 16 for each op: once a CPU `TorchNamespace`
    is made, the process's first f32 ``cos`` or ``sin`` through it, or
    ``sqrt`` or ``atan`` through torch, equals its second call."""
    from mosaic_tpu_torch.tools.first_call_sweep import sweep

    out = sweep(64, parallel=6, mode="trig", timeout_s=600.0)
    assert out["differing"] == 0, out["rows_differing"]


def test_cpu_namespace_sets_up_vector_math_once_a_process(monkeypatch):
    """The set-up is one one-element ``cos``, made by the first CPU
    namespace of a process and by no later one, on any thread; a CUDA
    namespace makes none."""
    import threading

    from mosaic_tpu_torch.core.index.h3 import hexmath

    calls = []
    real = torch.cos
    monkeypatch.setattr(torch, "cos", lambda x: calls.append(x.numel()) or real(x))
    monkeypatch.setattr(hexmath, "_CPU_MATH_READY", False)
    hexmath.TorchNamespace("cpu")
    hexmath.TorchNamespace("cpu")
    assert calls == [1]
    t = threading.Thread(target=hexmath.TorchNamespace, args=("cpu",))  # lint: thread-context-adoption-ok (the test needs a fresh thread with no context)
    t.start()
    t.join()
    hexmath.TorchNamespace("cuda")  # builds nothing, sets up nothing
    assert calls == [1]
