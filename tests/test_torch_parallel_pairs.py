"""The port's sharded pair axes (`mosaic_tpu_torch/parallel/dist_knn.py`,
`dist_overlay.py`, and the meshed overlay measures) on the CPU.

Mirrors, case for case, `tests/test_dist_knn.py` (the sharded SpatialKNN
at 2 and 8 devices, its bounded cache, brute force),
`tests/test_dist_overlay.py` (the sharded pair predicate, the
shift-keeping pad) and `tests/test_overlay_device.py::
test_mesh_sharded_bit_identity`. The reference runs on its 8 virtual CPU
devices; the port runs each meshed call on a logical CPU mesh of the
same shape (``devices=["cpu"] * n``). Every meshed answer is held bit for
bit (tolerance 0; float64 through an integer view) against the port's
single-device call and against the reference's meshed call on the same
seeded numpy inputs.
"""

import numpy as np
import pytest

from mosaic_tpu import expr as RE
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.index.h3 import H3IndexSystem as RefH3
from mosaic_tpu.functions import geometry as RF
from mosaic_tpu.functions.formats import st_point as ref_st_point
from mosaic_tpu.models.knn import SpatialKNN as RefSpatialKNN
from mosaic_tpu.parallel import dist_join as RD
from mosaic_tpu.parallel.dist_overlay import (
    distributed_pair_intersects as ref_pair_intersects,
)
from mosaic_tpu.sql.overlay import overlay_measures as ref_overlay_measures
from mosaic_tpu_torch import expr as E
from mosaic_tpu_torch.core.geometry.predicates import intersects
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
from mosaic_tpu_torch.functions.geometry import _pair_pack, _vmap_pair, st_overlap_fraction
from mosaic_tpu_torch.models import SpatialKNN
from mosaic_tpu_torch.parallel import dist_join as D
from mosaic_tpu_torch.parallel.dist_knn import clear_knn_caches, knn_cache_stats
from mosaic_tpu_torch.parallel.dist_overlay import (
    _pad_pair_axis,
    distributed_pair_intersects,
)
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.sql.overlay import overlay_measures
from torch_knn_fixtures import bits, port

RES = 7
BBOX = (-74.05, 40.60, -73.85, 40.78)


def logical_mesh(n, **kw):
    """The port's stand-in for the reference's ``make_mesh(n, ...)``."""
    return D.make_mesh(n, devices=["cpu"] * n, **kw)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------- dist_knn


def _points(n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform((BBOX[0], BBOX[1]), (BBOX[2], BBOX[3]), (n, 2))
    return ref_st_point(xy[:, 0], xy[:, 1]), xy


def _knn_equal(a, b):
    for f in ("landmark_id", "candidate_id", "rank"):
        _same(getattr(a, f), getattr(b, f))
    _same(bits(a.distance), bits(b.distance))
    assert a.metrics["match_count"] == b.metrics["match_count"]


@pytest.mark.parametrize("n_devices", [2, 8])
def test_mesh_knn_equals_single_device(n_devices):
    lm, _ = _points(9, seed=1)  # 9 landmarks: pair batches hit padding
    cd, _ = _points(57, seed=2)
    args = dict(resolution=RES, k_neighbours=4, max_iterations=8)
    r1 = SpatialKNN(H3IndexSystem(), device="cpu", **args).transform(port(lm), port(cd))
    rm = SpatialKNN(H3IndexSystem(), mesh=logical_mesh(n_devices), device="cpu",
                    **args).transform(port(lm), port(cd))
    _knn_equal(rm, r1)
    ref = RefSpatialKNN(index=RefH3(), mesh=RD.make_mesh(n_devices), **args).transform(lm, cd)
    _knn_equal(rm, ref)


def test_knn_cache_stats_and_clear():
    lm, _ = _points(5, seed=3)
    cd, _ = _points(33, seed=4)
    args = dict(resolution=RES, k_neighbours=3, max_iterations=6)
    clear_knn_caches()
    with telemetry.capture() as events:
        got = SpatialKNN(H3IndexSystem(), mesh=logical_mesh(2), device="cpu",
                         **args).transform(port(lm), port(cd))
        stats = knn_cache_stats()
    dist = stats["sharded_distance"]
    assert dist["currsize"] == 1  # one mesh -> one cached program
    assert dist["maxsize"] == 8   # bounded
    assert dist["hits"] >= 1      # ring iterations share the program
    assert any(e["event"] == "knn_cache_stats" for e in events)
    with telemetry.capture() as events:
        pre = clear_knn_caches()
    assert pre["sharded_distance"]["currsize"] == 1
    assert knn_cache_stats(emit=False)["sharded_distance"]["currsize"] == 0
    assert any(e["event"] == "knn_caches_cleared" for e in events)
    _knn_equal(got, SpatialKNN(H3IndexSystem(), device="cpu", **args).transform(
        port(lm), port(cd)))
    _knn_equal(got, RefSpatialKNN(index=RefH3(), mesh=RD.make_mesh(2), **args).transform(
        lm, cd))


def test_mesh_knn_matches_bruteforce():
    lm, lxy = _points(7, seed=5)
    cd, cxy = _points(64, seed=6)
    k = 3
    args = dict(resolution=RES, k_neighbours=k, max_iterations=12, approximate=False)
    r = SpatialKNN(H3IndexSystem(), mesh=logical_mesh(8), device="cpu",
                   **args).transform(port(lm), port(cd))
    d = np.linalg.norm(lxy[:, None, :] - cxy[None, :, :], axis=2)
    for i in range(7):
        want = np.argsort(d[i], kind="stable")[:k]
        got = r.candidate_id[r.landmark_id == i]
        order = np.argsort(r.rank[r.landmark_id == i])
        np.testing.assert_array_equal(got[order], want)
    _knn_equal(r, SpatialKNN(H3IndexSystem(), device="cpu", **args).transform(
        port(lm), port(cd)))
    _knn_equal(r, RefSpatialKNN(index=RefH3(), mesh=RD.make_mesh(8), **args).transform(
        lm, cd))


# --------------------------------------------------------- dist_overlay


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    a, b = [], []
    for _ in range(n):
        x, y = rng.uniform(0, 10, 2)
        s1, s2 = rng.uniform(0.5, 2.0, 2)
        dx, dy = rng.uniform(-2.0, 2.0, 2)
        a.append(
            f"POLYGON (({x} {y}, {x + s1} {y}, {x + s1} {y + s1},"
            f" {x} {y + s1}, {x} {y}))"
        )
        b.append(
            f"POLYGON (({x + dx} {y + dy}, {x + dx + s2} {y + dy},"
            f" {x + dx + s2} {y + dy + s2}, {x + dx} {y + dy + s2},"
            f" {x + dx} {y + dy}))"
        )
    return wkt.from_wkt(a), wkt.from_wkt(b)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_dist_pair_intersects_matches_single_device(n_devices):
    a, b = _pairs(37, seed=5)  # 37: deliberately not a mesh multiple
    da, db = _pair_pack(port(a), port(b), device="cpu")
    got = distributed_pair_intersects(logical_mesh(n_devices), da, db)
    _same(got, _vmap_pair(intersects, da, db).numpy())
    _same(got, np.asarray(RF.st_intersects(a, b)))
    _same(got, np.asarray(RF.st_intersects(a, b, backend="oracle")))
    _same(got, ref_pair_intersects(RD.make_mesh(n_devices), *RF._pair_pack(a, b)))
    assert got.any() and not got.all()  # the layout mixes hits and misses


def test_pad_preserves_shift_invariant():
    # padding the pair axis to a mesh multiple must not touch the shared
    # (2,) shift, even when the pair count is exactly 2
    a, b = _pairs(2, seed=7)
    da, db = _pair_pack(port(a), port(b), device="cpu")
    padded = _pad_pair_axis(da, 6)
    assert padded.shift.shape == (2,)
    assert padded.verts.shape[0] == 8 and padded.geom_type.shape[0] == 8
    got = distributed_pair_intersects(logical_mesh(8), da, db)
    _same(got, _vmap_pair(intersects, da, db).numpy())
    _same(got, ref_pair_intersects(RD.make_mesh(8), *RF._pair_pack(a, b)))


def test_overlay_mesh_sharded_bit_identity():
    """`tests/test_overlay_device.py::test_mesh_sharded_bit_identity`:
    the meshed overlay measures equal the single-device ones and the
    reference's meshed ones, bit for bit; so does `st_overlap_fraction`
    with ``mesh=`` passed through."""
    conf = (-180, 180, -90, 90, 2, 10.0, 10.0)

    def squares(specs):
        return wkt.from_wkt([
            f"POLYGON (({x0} {y0}, {x0 + w} {y0}, {x0 + w} {y0 + h},"
            f" {x0} {y0 + h}, {x0} {y0}))"
            for x0, y0, w, h in specs
        ])

    left = squares([(i * 2.9, j * 2.9, 2.7, 2.7) for i in range(3) for j in range(3)])
    right = squares([(i * 2.9 + 0.9, j * 2.9 + 0.6, 2.4, 2.4)
                     for i in range(3) for j in range(3)])
    grid = CustomIndexSystem(GridConf(*conf))
    single = overlay_measures(port(left), port(right), grid, 3, E.overlap_fraction(),
                              device="cpu")
    meshed = overlay_measures(port(left), port(right), grid, 3, E.overlap_fraction(),
                              device="cpu", mesh=D.make_mesh(8, devices=["cpu"] * 8))
    ref = ref_overlay_measures(left, right, RefCustom(RefConf(*conf)), 3,
                               RE.overlap_fraction(), mesh=8)
    # the function frontend passes mesh= through
    framed = st_overlap_fraction(port(left), port(right), grid, 3, device="cpu",
                                 mesh=D.make_mesh(8, devices=["cpu"] * 8))
    assert meshed.lane == "device" and not meshed.degraded
    for f in ("pairs", "value", "valid", "area", "sure"):
        _same(getattr(meshed, f), getattr(single, f))
        _same(getattr(meshed, f), np.asarray(getattr(ref, f)))
        _same(getattr(framed, f), getattr(single, f))
