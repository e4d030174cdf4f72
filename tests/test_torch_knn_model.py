"""The port's batch KNN model (`mosaic_tpu_torch/models/knn.py
SpatialKNN`) held against the reference's on the CPU, bit for bit:
exact and approximate modes, a distance threshold, polygon landmarks,
checkpoints, H3 and the custom grid, and agreement with the served
frontend on the same candidates. Past the retry budget a model on the
CPU degrades to the f64 oracle (`core/geometry/oracle.pair_distance`),
which agrees to 1e-12 (it is not the device program's expression)."""

import numpy as np
import pytest

from mosaic_tpu import functions as RF
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.models import SpatialKNN as RefSpatialKNN
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.knn import KNNFrontend, build_knn_index
from mosaic_tpu_torch.models import CheckpointManager, SpatialKNN
from mosaic_tpu_torch.runtime import faults
from torch_knn_fixtures import CONF, RES, bits, l_shapes, port, square_wkts


@pytest.fixture(scope="module")
def grids():
    return RefCustom(RefConf(*CONF)), CustomIndexSystem(GridConf(*CONF))


@pytest.fixture(scope="module")
def problem(grids):
    rng = np.random.default_rng(11)
    polys, cx, cy = square_wkts(rng, 100)
    cand = RF.st_geomfromwkt(np.array(polys))
    kx = build_knn_index(port(cand), grids[1], RES, device="cpu")
    lo = np.array([cx.min(), cy.min()])
    hi = np.array([cx.max(), cy.max()])

    def qpts(n, seed):
        r = np.random.default_rng(seed)
        return lo + r.uniform(0.1, 0.9, (n, 2)) * (hi - lo)

    return cand, None, kx, qpts


def _flat(res, L, k):
    ids = np.full((L, k), -1, np.int64)
    dist = np.full((L, k), np.inf)
    for li, ci, d, r in zip(res.landmark_id, res.candidate_id, res.distance, res.rank):
        ids[li, r - 1] = ci
        dist[li, r - 1] = d
    return ids, dist


def _model_pair(grid_pair, landmarks, candidates, **kw):
    rg, pg = grid_pair
    ref = RefSpatialKNN(index=rg, **kw).transform(landmarks, candidates)
    got = SpatialKNN(pg, device="cpu", **kw).transform(port(landmarks), port(candidates))
    return got, ref


def _assert_same_result(got, ref):
    for f in ("landmark_id", "candidate_id", "rank"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    np.testing.assert_array_equal(bits(got.distance), bits(ref.distance))
    for key in ("match_count", "iterations", "complete_landmarks", "max_kth_distance",
                "degraded"):
        assert got.metrics[key] == ref.metrics[key], key


def test_spatial_knn_exact_equals_reference_and_frontend(problem, grids):
    cand, rkx, kx, qpts = problem
    q = qpts(12, seed=21)
    land = RF.st_point(q[:, 0], q[:, 1])
    got, ref = _model_pair(grids, land, cand, resolution=RES, k_neighbours=3,
                           max_iterations=60, early_stop_iterations=100,
                           approximate=False)
    _assert_same_result(got, ref)
    ids, dist = _flat(got, 12, 3)
    out = KNNFrontend(kx).dispatch(q, 3)[0]
    np.testing.assert_array_equal(ids, out[:, 3:].astype(np.int64))
    np.testing.assert_array_equal(bits(dist), bits(out[:, :3]))


def test_spatial_knn_approximate_threshold_polygons_and_checkpoint(grids, tmp_path):
    rng = np.random.default_rng(17)
    zones = wkt.from_wkt(square_wkts(rng, 30, side=(1.0, 4.0))[0] + l_shapes(rng, 5))
    land = wkt.from_wkt(square_wkts(rng, 6, side=(0.5, 2.0))[0])
    ck = str(tmp_path / "knn_ck")
    rg, pg = grids
    kw = dict(resolution=RES, k_neighbours=4, max_iterations=6, early_stop_iterations=2,
              distance_threshold=9.0)
    ref = RefSpatialKNN(index=rg, **kw).transform(land, zones)
    got = SpatialKNN(pg, device="cpu", checkpoint_dir=ck, **kw).transform(
        port(land), port(zones))
    _assert_same_result(got, ref)
    log = CheckpointManager(ck).load()
    assert log["iteration"].max() == got.metrics["iterations"]
    assert CheckpointManager(ck).read_meta()["match_count"] == got.metrics["match_count"]


def test_spatial_knn_h3_points(problem):
    """H3 at resolution 8 over NYC, point candidates (the reference's
    `test_models_services.py` exact-points case)."""
    from mosaic_tpu.datasets import random_points

    bbox = (-74.05, 40.60, -73.85, 40.78)
    lp, cp = random_points(8, bbox=bbox, seed=1), random_points(60, bbox=bbox, seed=2)
    land, cand = RF.st_point(lp[:, 0], lp[:, 1]), RF.st_point(cp[:, 0], cp[:, 1])
    kw = dict(resolution=8, k_neighbours=3, max_iterations=30, approximate=False)
    ref = RefSpatialKNN(index=RefH3(), **kw).transform(land, cand)
    got = SpatialKNN(H3IndexSystem(), device="cpu", **kw).transform(port(land), port(cand))
    _assert_same_result(got, ref)


def test_spatial_knn_degrades_on_the_cpu_past_the_budget(problem, grids):
    cand, _, _, qpts = problem
    q = qpts(4, seed=5)
    land = port(RF.st_point(q[:, 0], q[:, 1]))
    m = SpatialKNN(grids[1], RES, k_neighbours=2, max_iterations=40, approximate=False,
                   early_stop_iterations=100, device="cpu")
    want = m.transform(land, port(cand))
    with faults.transient_errors(10_000, sites=("knn.pair_distances",)):
        got = m.transform(land, port(cand))
    assert got.metrics["degraded"] and not want.metrics["degraded"]
    np.testing.assert_array_equal(got.candidate_id, want.candidate_id)
    np.testing.assert_allclose(got.distance, want.distance, rtol=0, atol=1e-12)
