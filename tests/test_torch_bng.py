"""The British National Grid index of the port against the JAX package.

Mirrors the BNG half of `tests/test_index_bng_custom.py` on
`mosaic_tpu_torch.core.index.bng`, and holds every function to the
reference's on the same numpy inputs (tolerance 0): ids, resolutions,
centers, boundaries, neighbours, distances, strings, polyfill
candidates, and the epsilon-band margins in f32 and f64 (each step is a
floor, an integer division or an IEEE division and rounding, so numpy,
torch and XLA give the same bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mosaic_tpu.core.index import BNG as RefBNG
from mosaic_tpu_torch.core.index import BNG

RES_ALL = BNG.resolutions()


def _pts(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return np.column_stack(
        [rng.uniform(0, 700_000, n), rng.uniform(0, 1_300_000, n)]
    )


def test_resolutions_and_names_equal_reference():
    assert BNG.resolutions() == RefBNG.resolutions()
    for r in RES_ALL:
        assert BNG.resolution_str(r) == RefBNG.resolution_str(r)
        assert BNG.resolution_arg(BNG.resolution_str(r)) == r
        assert BNG.edge_size(r) == RefBNG.edge_size(r)
        assert BNG.buffer_radius(r) == RefBNG.buffer_radius(r)
        assert BNG.cell_area_approx(r) == RefBNG.cell_area_approx(r)
    assert (BNG.name, BNG.crs_srid, BNG.boundary_max_verts) == (
        RefBNG.name, RefBNG.crs_srid, RefBNG.boundary_max_verts)


@pytest.mark.parametrize("res", RES_ALL)
def test_point_to_cell_equals_reference(res):
    """numpy f64, torch f64 and torch f32 ids equal the reference's."""
    pts = _pts(seed=abs(res))
    want = np.asarray(RefBNG.point_to_cell(jnp.asarray(pts), res))
    np.testing.assert_array_equal(BNG.point_to_cell(pts, res), want)
    np.testing.assert_array_equal(
        BNG.point_to_cell(torch.from_numpy(pts), res).numpy(), want)
    want32 = np.asarray(RefBNG.point_to_cell(jnp.asarray(pts, jnp.float32), res))
    got32 = BNG.point_to_cell(torch.from_numpy(pts).float(), res)
    assert got32.dtype == torch.int64
    np.testing.assert_array_equal(got32.numpy(), want32)


@pytest.mark.parametrize("res", RES_ALL)
def test_margins_equal_reference(res):
    pts = _pts(seed=10 + abs(res))
    pts[:5] = np.round(pts[:5] / 1000.0) * 1000.0  # on binning boundaries
    for xy, ref_xy in (
        (pts, pts),
        (torch.from_numpy(pts).float(), jnp.asarray(pts, jnp.float32)),
    ):
        c, m = BNG.point_to_cell_margin(xy, res)
        rc, rm = RefBNG.point_to_cell_margin(ref_xy, res)
        c = c.numpy() if isinstance(c, torch.Tensor) else c
        m = m.numpy() if isinstance(m, torch.Tensor) else m
        np.testing.assert_array_equal(c, np.asarray(rc))
        np.testing.assert_array_equal(m, np.asarray(rm))
        assert m.dtype == np.asarray(rm).dtype
    assert BNG.point_to_cell_alt(pts, res) is None


@pytest.mark.parametrize("res", RES_ALL)
def test_decode_functions_equal_reference(res):
    cells = BNG.point_to_cell(_pts(seed=20 + abs(res)), res)
    for fn in ("resolution_of", "cell_center", "cell_boundary", "is_valid"):
        np.testing.assert_array_equal(
            getattr(BNG, fn)(cells), np.asarray(getattr(RefBNG, fn)(cells)), err_msg=fn)
    for k in (1, 2):
        np.testing.assert_array_equal(BNG.k_ring(cells[:20], k),
                                      np.asarray(RefBNG.k_ring(cells[:20], k)))
        np.testing.assert_array_equal(BNG.k_loop(cells[:20], k),
                                      np.asarray(RefBNG.k_loop(cells[:20], k)))
    np.testing.assert_array_equal(
        BNG.grid_distance(cells[:50], cells[50:100]),
        np.asarray(RefBNG.grid_distance(cells[:50], cells[50:100])))
    assert BNG.format(cells) == RefBNG.format(cells)


def test_tensor_inputs_come_back_as_tensors():
    cells = BNG.point_to_cell(torch.from_numpy(_pts(10)), 3)
    assert isinstance(BNG.cell_center(cells), torch.Tensor)
    assert isinstance(BNG.k_ring(cells, 1), torch.Tensor)
    np.testing.assert_array_equal(BNG.cell_center(cells).numpy(),
                                  BNG.cell_center(cells.numpy()))


@pytest.mark.parametrize("bounds, res", [
    ((100_000, 100_000, 130_000, 120_000), 2),
    ((395_000, 195_000, 485_000, 245_000), 3),
    ((0, 0, 40_000, 30_000), -2),
])
def test_polyfill_candidates_equal_reference(bounds, res):
    b = np.array(bounds, dtype=np.float64)
    np.testing.assert_array_equal(BNG.polyfill_candidates(b, res),
                                  np.asarray(RefBNG.polyfill_candidates(b, res)))


# ---- the reference's own BNG cases, on the port


def test_point_roundtrip_all_res():
    pts = _pts()
    for res in RES_ALL:
        cells = BNG.point_to_cell(pts, res)
        assert BNG.resolution_of(cells).tolist() == [res] * 200
        centers = BNG.cell_center(cells)
        np.testing.assert_array_equal(cells, BNG.point_to_cell(centers, res))
        assert np.all(np.abs(centers - pts) <= BNG.edge_size(res))


def test_known_strings():
    pts = np.asarray([[216650.0, 771250.0]])
    assert BNG.format(BNG.point_to_cell(pts, 1)) == ["NN"]
    assert BNG.format(BNG.point_to_cell(pts, 2)) == ["NN17"]
    assert BNG.format(BNG.point_to_cell(pts, 4)) == ["NN166712"]


def test_quadrant_res():
    pts = np.asarray([
        [510_000.0, 110_000.0],  # SW
        [510_000.0, 160_000.0],  # NW
        [560_000.0, 160_000.0],  # NE
        [560_000.0, 110_000.0],  # SE
    ])
    cells = BNG.point_to_cell(pts, -2)
    assert BNG.format(cells) == ["TQSW", "TQNW", "TQNE", "TQSE"]
    np.testing.assert_array_equal(BNG.parse(BNG.format(cells)), cells)


def test_format_parse_roundtrip():
    pts = _pts(50, seed=1)
    for res in [1, 2, 3, -2, -3, 4, -4, 5, 6]:
        cells = BNG.point_to_cell(pts, res)
        strs = BNG.format(cells)
        np.testing.assert_array_equal(BNG.parse(strs), cells)
        np.testing.assert_array_equal(BNG.parse(strs), RefBNG.parse(strs))


def test_k_ring_loop():
    c = BNG.point_to_cell(np.asarray([[400_000.0, 400_000.0]]), 3)
    ring = BNG.k_ring(c, 1)[0]
    assert (ring >= 0).sum() == 9
    loop = BNG.k_loop(c, 1)[0]
    assert (loop >= 0).sum() == 8
    assert int(c[0]) not in loop.tolist()
    edge_c = BNG.point_to_cell(np.asarray([[500.0, 500.0]]), 3)
    assert (BNG.k_ring(edge_c, 1)[0] >= 0).sum() == 4


def test_grid_distance():
    a = BNG.point_to_cell(np.asarray([[100_500.0, 100_500.0]]), 3)
    b = BNG.point_to_cell(np.asarray([[103_500.0, 104_500.0]]), 3)
    assert int(BNG.grid_distance(a, b)[0]) == 4  # Chebyshev


def test_distance_consistent_with_kloop():
    c = BNG.point_to_cell(np.asarray([[400_000.0, 400_000.0]]), 3)
    for k in [1, 2, 3]:
        loop = BNG.k_loop(c, k)[0]
        loop = loop[loop >= 0]
        d = BNG.grid_distance(np.broadcast_to(c, (len(loop),)), loop)
        assert (d == k).all()


def test_boundary():
    c = BNG.point_to_cell(np.asarray([[216_650.0, 771_250.0]]), 2)
    b = BNG.cell_boundary(c)[0]
    np.testing.assert_allclose(b[0], [210_000, 770_000])
    np.testing.assert_allclose(b[2], [220_000, 780_000])
    np.testing.assert_allclose(b[0], b[4])


def test_polyfill_candidates():
    cand = BNG.polyfill_candidates(np.array([100_000, 100_000, 130_000, 120_000]), 2)
    assert len(cand) == 3 * 2
    assert len(set(cand.tolist())) == 6


def test_500km_blocks():
    pts = np.asarray([[100.0, 100.0], [600_000.0, 100.0], [100.0, 1_200_000.0]])
    cells = BNG.point_to_cell(pts, -1)
    assert BNG.format(cells) == ["S", "T", "H"]
    np.testing.assert_array_equal(BNG.parse(["S", "T", "H"]), cells)
