"""The exact lane at H3 cell edges (`sql/join.py recheck_oracle`).

Chips are clipped to each cell's boundary ring, whose edges are straight
in lon/lat; an H3 cell's own edges are not. A point within about 1e-9
degrees of a cell edge can lie outside the ring of its f64 cell and
inside a neighbour's, where :func:`host_join`, reading only the f64
cell's chips, misses the zone that holds it. ``pip_join(recheck=True)``
answers such points from the ring that holds them, and equals the plain
float64 reference (`geobench/reference/pip.py`) point for point.

Plain torch and numpy: the JAX package is not imported here."""

import json
import os

import numpy as np
import pytest
import torch

from geobench import points as bench_points
from geobench import polygons as bench_polygons
from geobench import port as bench_port
from geobench.reference import pip as reference
from mosaic_tpu_torch.core.index import H3IndexSystem
from mosaic_tpu_torch.sql import join as TJ

H3 = H3IndexSystem()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "geobench", "configs", "taxi_zones_r9_exact.json")

#: point 185,507 of 400k ``zone_edges`` points (sigma 15 m, seed 4) over
#: the configuration's zones: 2.65e-6 degrees inside zone 188, 1.29e-9
#: degrees outside the ring of its f64 cell
GAP_POINT = (-73.77607553603758, 40.852057502499825)
GAP_CELL = 617733120278921215
GAP_RING_CELL = 617733120278659071
#: zone 188 and the zones whose boxes meet its box
NEAR_188 = (171, 172, 173, 187, 188, 189, 203, 204, 205)


def subset(polys, ids):
    return bench_polygons.Polygons.from_rings([
        [polys.xy[polys.ring_offsets[r]:polys.ring_offsets[r + 1]]
         for r in range(polys.geom_rings[g], polys.geom_rings[g + 1])]
        for g in ids])


def ring_holds(points, cells):
    """Plain even-odd test of each point against its cell's boundary."""
    ring = np.asarray(H3.cell_boundary(cells))
    a, b = ring, np.roll(ring, -1, axis=1)
    px, py = points[:, :1], points[:, 1:]
    st = (a[..., 1] > py) != (b[..., 1] > py)
    xc = a[..., 0] + (py - a[..., 1]) * (b[..., 0] - a[..., 0]) / np.where(
        b[..., 1] == a[..., 1], 1.0, b[..., 1] - a[..., 1])
    return (st & (px < xc)).sum(axis=1) % 2 == 1


def join(pts, ix, recheck, probe="adaptive"):
    return TJ.pip_join(pts, None, H3, 9, chip_index=ix, recheck=recheck, probe=probe,
                       device="cpu")


@pytest.fixture(scope="module")
def near_188():
    with open(CONFIG, encoding="utf-8") as f:
        conf = json.load(f)
    polys = bench_polygons.make(conf["polygons"])
    ids = np.asarray(NEAR_188)
    ix = bench_port.build_index(subset(polys, ids), H3, 9, torch.device("cpu"))
    return polys, ids, ix


def test_traced_gap_point_is_answered_by_the_ring_that_holds_it(near_188):
    polys, ids, ix = near_188
    p = np.asarray([GAP_POINT])
    assert int(reference.answers(polys, p, "cpu")[0]) == 188
    # its f64 cell's ring misses it; the neighbour's holds it
    assert H3.point_to_cell(p, 9)[0] == GAP_CELL
    assert not ring_holds(p, np.asarray([GAP_CELL]))[0]
    assert ring_holds(p, np.asarray([GAP_RING_CELL]))[0]
    # the float32 lane assigns it to the other cell of the edge
    f32_cell = H3.point_to_cell(torch.tensor(p, dtype=torch.float32), 9)
    assert int(f32_cell[0]) == GAP_RING_CELL
    f32 = join(p, ix, recheck=False)
    exact = join(p, ix, recheck=True)
    assert ids[exact[0]] == 188
    assert ids[f32[0]] == 188 and int(f32_cell[0]) != GAP_CELL
    # the oracle keeps the JAX package's bits: the repair is the recheck's
    assert TJ.host_join(p, ix.host, H3, 9)[0] == -1
    assert ids[TJ.recheck_oracle(p, ix.host, H3, 9)[0]] == 188


@pytest.fixture(scope="module")
def small_lattice():
    params = {"kind": "star_lattice", "nx": 3, "ny": 3, "verts": 64, "seed": 7,
              "jitter": 0.45, "bbox": [-73.99, 40.70, -73.95, 40.74]}
    polys = bench_polygons.make(params)
    ix = bench_port.build_index(polys, H3, 9, torch.device("cpu"))
    return params, polys, ix


def gap_points(ix, n_cells=60):
    """Points a few 1e-10 degrees either side of the midpoints and
    thirds of the ring edges of cells whose chips cross a zone edge."""
    h = ix.host
    crossing = ((h.cell_slot_geom >= 0) & ~h.cell_slot_core).any(axis=1)
    cells = h.cells[crossing][:n_cells]
    ring = np.asarray(H3.cell_boundary(cells))
    a, d = ring[:, :-1], np.diff(ring, axis=1)
    normal = np.stack([d[..., 1], -d[..., 0]], -1) / np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([(a + f * d + t * normal).reshape(-1, 2)
                           for t in (-1e-9, -3e-10, 3e-10, 1e-9) for f in (1 / 3, 0.5, 2 / 3)])


def seeded_points(params, polys, seed):
    gen = bench_points.generator(seed, "cpu")
    conf = {"points_bbox": params["bbox"]}
    curb = bench_points.make({"kind": "zone_edges", "sigma_m": 15.0}, conf, polys, 6000,
                             gen, "cpu").numpy()
    flat = bench_points.make({"kind": "uniform"}, conf, polys, 3000, gen, "cpu").numpy()
    return curb, flat


@pytest.mark.parametrize("probe", ["scatter", "adaptive"])
def test_exact_lane_equals_the_reference_with_gap_points(small_lattice, probe):
    params, polys, ix = small_lattice
    gaps = gap_points(ix)
    outside = ~ring_holds(gaps, H3.point_to_cell(gaps, 9))
    assert outside.any()
    pts = np.concatenate([*seeded_points(params, polys, 2**31 + 41), gaps])
    want = reference.answers(polys, pts, "cpu").numpy()
    # the gap bites: the f64 cell's chips alone miss some of these points
    assert (TJ.host_join(gaps, ix.host, H3, 9) != want[-len(gaps):]).any()
    got = join(pts, ix, recheck=True, probe=probe)
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("block", [TJ.ORACLE_BLOCK, 1000])
def test_oracle_is_host_join_where_the_f64_cell_holds_the_point(small_lattice, block,
                                                               monkeypatch):
    monkeypatch.setattr(TJ, "ORACLE_BLOCK", block)
    params, polys, ix = small_lattice
    pts = np.concatenate([*seeded_points(params, polys, 7), gap_points(ix, 20)])
    held = ring_holds(pts, H3.point_to_cell(pts, 9))
    assert held.any() and (~held).any()
    oracle = TJ.recheck_oracle(pts, ix.host, H3, 9)
    np.testing.assert_array_equal(oracle[held], TJ.host_join(pts[held], ix.host, H3, 9))
    want = reference.answers(polys, pts, "cpu").numpy()
    np.testing.assert_array_equal(oracle, want)


def test_rows_near_a_runner_up_chip_edge_go_to_the_oracle(small_lattice, monkeypatch):
    """A point in the cell band is re-joined on its runner-up cell; where it
    lies near a chip edge there, the f32 answer may be wrong and agree
    with the first cell's by chance, so the row goes to the oracle."""
    params, polys, ix = small_lattice
    # within millimetres of a zone edge: inside the edge band
    gen = bench_points.generator(2**31 + 43, "cpu")
    pts = bench_points.make({"kind": "zone_edges", "sigma_m": 0.005},
                            {"points_bbox": params["bbox"]}, polys, 20000, gen, "cpu").numpy()
    sent = []
    real = TJ.recheck_oracle

    def spy(p, *a, **k):
        sent.append(np.asarray(p).copy())
        return real(p, *a, **k)

    monkeypatch.setattr(TJ, "recheck_oracle", spy)
    got = join(pts, ix, recheck=True)
    assert int((got != reference.answers(polys, pts, "cpu").numpy()).sum()) == 0
    oracle = {tuple(p) for p in np.concatenate(sent)}
    # the band's rows near a chip edge of their runner-up cell, found apart
    q = torch.from_numpy(pts).to(torch.float32)
    _, margins = H3.point_to_cell_margin(q, 9)
    eps32 = float(np.finfo(np.float32).eps)
    band = np.nonzero((margins[:, 0] < TJ.CELL_MARGIN_K * eps32).numpy())[0]
    alt = H3.point_to_cell_alt(q[band], 9)
    shifted = (torch.from_numpy(pts[band]) - ix.border.shift).to(torch.float32)
    eps2 = float(np.float32((TJ.EDGE_BAND_K * eps32 * ix.host.coord_scale) ** 2))
    _, near = TJ.pip_join_points(shifted, alt, ix, edge_eps2=eps2)
    rows = band[near.numpy()]
    assert rows.size
    assert all(tuple(p) in oracle for p in pts[rows])
