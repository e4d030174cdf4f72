"""KNN serving in the port (`ServeEngine(knn=...)`, `submit_knn`,
`ServeRouter.submit_knn`) on the CPU, mirroring the reference's
`tests/test_knn_serve.py` class for class on its fixture (the custom
grid at resolution 3, 100 seeded squares, three PIP zones). Every
answer is compared bit for bit (tolerance 0): served KNN answers equal
the engine-less frontend, the batch `SpatialKNN` model, the brute-force
f64 oracle and the REFERENCE engine's served answers on the same seeded
requests; PIP rows of a mixed batch keep their solo bits.

Not mirrored: the reference's convex-share tune routing
(`TestTuneRouting`, ROADMAP queue 1 item 13) and `TestBatchModelCache`.
The frontend's program-store entries are `tests/test_torch_programs.py`'s.
"""

import time

import numpy as np
import pytest

from mosaic_tpu import functions as RF
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.knn import KNNFrontend as RefFrontend
from mosaic_tpu.knn import build_knn_index as ref_build
from mosaic_tpu.serve import BucketLadder as RefLadder
from mosaic_tpu.serve import ServeEngine as RefEngine
from mosaic_tpu.sql.join import build_chip_index as ref_build_chip_index
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.knn import KNNFrontend, brute_force_knn, build_knn_index, decode_knn
from mosaic_tpu_torch.models import SpatialKNN
from mosaic_tpu_torch.runtime import RetryExhausted, faults
from mosaic_tpu_torch.runtime.errors import Overloaded
from mosaic_tpu_torch.serve import BucketLadder, ServeEngine, ServeRouter
from mosaic_tpu_torch.sql.join import build_chip_index
from torch_knn_fixtures import (
    BBOX, CONF, PAIRS, RES, ROWS, bits, l_shapes, port, square_wkts,
)

PIP_ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
    "POLYGON ((20 -10, 30 -10, 30 5, 20 5, 20 -10))",
]


@pytest.fixture(scope="module")
def grid():
    return CustomIndexSystem(GridConf(*CONF))


@pytest.fixture(scope="module")
def pip_index(grid):
    col = port(wkt.from_wkt(PIP_ZONES))
    return build_chip_index(tessellate(col, grid, RES, keep_core_geoms=False), device="cpu")


@pytest.fixture(scope="module")
def knn_problem(grid):
    """Dense convex candidates + a query sampler staying strictly inside
    the candidate bbox (the shift contract the bit identity rests on)."""
    rng = np.random.default_rng(11)
    polys, cx, cy = square_wkts(rng, 100)
    cand = RF.st_geomfromwkt(np.array(polys))
    kx = build_knn_index(port(cand), grid, RES, device="cpu")
    lo = np.array([cx.min(), cy.min()])
    hi = np.array([cx.max(), cy.max()])

    def qpts(n, seed):
        r = np.random.default_rng(seed)
        return lo + r.uniform(0.1, 0.9, (n, 2)) * (hi - lo)

    return cand, kx, qpts


@pytest.fixture(scope="module")
def frontend(knn_problem):
    _, kx, _ = knn_problem
    fe = KNNFrontend(kx, lane="ring", row_ladder=BucketLadder(*ROWS),
                     pair_ladder=BucketLadder(*PAIRS))
    rep = fe.warmup()
    assert rep["signatures"] == len(fe.row_ladder.buckets) + len(fe.pair_ladder.buckets)
    return fe


@pytest.fixture(scope="module")
def engine(pip_index, grid, frontend):
    """One warmed mixed-traffic engine shared by the module (the warmed
    frontend is adopted as it is)."""
    eng = ServeEngine(
        pip_index, grid, RES, ladder=BucketLadder(64, 1024), bounds=BBOX,
        max_wait_s=0.05, knn=frontend, default_deadline_s=30.0,
    )
    info = eng.warmup()
    assert info["knn"]["signatures"] == 14 and info["backend_compiles"] == 0
    yield eng
    eng.close()


def oracle(kx, q, k):
    return brute_force_knn(q, kx, k)


def assert_answer(a, ids, dist):
    np.testing.assert_array_equal(a.ids, ids)
    np.testing.assert_array_equal(bits(a.distance), bits(dist))


class TestServedBitIdentity:
    def test_cobatched_equals_solo_equals_batch_equals_oracle(
        self, engine, frontend, knn_problem, grid
    ):
        """Concurrent KNN requests straddling the 8-row rung, co-batched
        into one mixed batch, answer the bits of the engine-less
        frontend, the exact batch model and the brute-force oracle."""
        cand, kx, qpts = knn_problem
        k = 3
        qs = [qpts(n, seed=40 + n) for n in (7, 8, 9)]
        futs = [engine.submit_knn(q, k) for q in qs]
        answers = [f.result(timeout=60) for f in futs]
        assert engine.metrics()["cold_compiles"] == 0
        allq = np.concatenate(qs)
        res = SpatialKNN(grid, RES, k_neighbours=k, max_iterations=60,
                         early_stop_iterations=100, approximate=False,
                         device="cpu").transform(port(RF.st_point(allq[:, 0], allq[:, 1])),
                                                 port(cand))
        bids = np.full((allq.shape[0], k), -1, np.int64)
        bdist = np.full((allq.shape[0], k), np.inf)
        for li, ci, d, r in zip(res.landmark_id, res.candidate_id, res.distance, res.rank):
            bids[li, r - 1] = ci
            bdist[li, r - 1] = d
        oids, odist = oracle(kx, allq, k)
        np.testing.assert_array_equal(bids, oids)
        np.testing.assert_array_equal(bits(bdist), bits(odist))
        off = 0
        for q, a in zip(qs, answers):
            n = q.shape[0]
            assert not a.degraded and a.ids.shape == (n, k)
            sids, sdist = decode_knn(frontend.dispatch(q, k)[0], k)
            assert_answer(a, sids, sdist)
            assert_answer(a, oids[off : off + n], odist[off : off + n])
            off += n

    def test_mixed_batch_leaves_pip_answers_bit_identical(self, engine, knn_problem):
        _, kx, qpts = knn_problem
        ppts = np.random.default_rng(4).uniform(BBOX[:2], BBOX[2:], (90, 2))
        fp = engine.submit(ppts)
        fk = engine.submit_knn(qpts(5, seed=77), 2)
        pip_rows = np.asarray(fp.result(timeout=60))
        a = fk.result(timeout=60)
        solo = np.asarray(engine.join(ppts, timeout=60))
        np.testing.assert_array_equal(pip_rows, solo)
        assert_answer(a, *oracle(kx, qpts(5, seed=77), 2))

    def test_served_answers_equal_the_reference_engine(self, engine, knn_problem):
        """The reference engine over the same candidates and zones serves
        the same KNN bits and PIP rows for the same seeded requests."""
        cand, _, qpts = knn_problem
        rg = RefCustom(RefConf(*CONF))
        rkx = ref_build(cand, index_system=rg, resolution=RES)
        rpix = ref_build_chip_index(ref_tessellate(wkt.from_wkt(PIP_ZONES), rg, RES,
                                                   keep_core_geoms=False))
        rfe = RefFrontend(rkx, row_ladder=RefLadder(*ROWS), pair_ladder=RefLadder(*PAIRS))
        with RefEngine(rpix, rg, RES, ladder=RefLadder(64, 1024), bounds=BBOX,
                       max_wait_s=0.05, knn=rfe, default_deadline_s=120.0) as ref:
            q = qpts(6, seed=91)
            ppts = np.random.default_rng(92).uniform(BBOX[:2], BBOX[2:], (70, 2))
            ra, rp = ref.submit_knn(q, 4), ref.submit(ppts)
            pa, pp = engine.submit_knn(q, 4), engine.submit(ppts)
            ra, rp = ra.result(timeout=120), rp.result(timeout=120)
            pa, pp = pa.result(timeout=60), pp.result(timeout=60)
        assert_answer(pa, ra.ids, ra.distance)
        np.testing.assert_array_equal(np.asarray(pp), np.asarray(rp))


class TestVoronoiLane:
    def test_voronoi_equals_ring_on_convex_fixture(self, frontend, knn_problem):
        _, kx, qpts = knn_problem
        fv = KNNFrontend(kx, lane="voronoi", row_ladder=BucketLadder(*ROWS),
                         pair_ladder=BucketLadder(*PAIRS))
        fv.warmup()
        q = qpts(11, seed=9)
        out_r, _ = frontend.dispatch(q, 4)
        out_v, _ = fv.dispatch(q, 4)
        np.testing.assert_array_equal(bits(out_v), bits(out_r))
        assert fv.stats["lane_voronoi"] == 11

    def test_voronoi_equals_ring_on_mixed_fixture(self, grid):
        rng = np.random.default_rng(5)
        polys, _, _ = square_wkts(rng, 40)
        cand = RF.st_geomfromwkt(np.array(polys + l_shapes(rng, 12)))
        kxm = build_knn_index(port(cand), grid, RES, device="cpu")
        fr = KNNFrontend(kxm, lane="ring", row_ladder=BucketLadder(*ROWS),
                         pair_ladder=BucketLadder(*PAIRS))
        fv = KNNFrontend(kxm, lane="voronoi", row_ladder=BucketLadder(*ROWS),
                         pair_ladder=BucketLadder(*PAIRS))
        q = np.stack([
            np.random.default_rng(8).uniform(BBOX[0] + 5, BBOX[2] - 5, 9),
            np.random.default_rng(9).uniform(BBOX[1] + 5, BBOX[3] - 5, 9),
        ], axis=1)
        np.testing.assert_array_equal(bits(fv.dispatch(q, 3)[0]), bits(fr.dispatch(q, 3)[0]))

    def test_engine_serves_the_voronoi_lane(self, pip_index, grid, knn_problem):
        _, kx, qpts = knn_problem
        q = qpts(7, seed=55)
        with ServeEngine(pip_index, grid, RES, ladder=BucketLadder(64, 256), bounds=BBOX,
                         knn=kx, knn_lane="voronoi", default_deadline_s=30.0) as eng:
            eng.warmup()
            a = eng.join_knn(q, 3, timeout=60)
            m = eng.metrics()
        assert_answer(a, *oracle(kx, q, 3))
        assert m["knn_lane_voronoi"] == 7 and m["knn_queries"] == 7
        assert m["cold_compiles"] == 0


class TestDeadlinesAndQuarantine:
    def test_stalled_knn_sheds_only_the_late_request(self, engine, knn_problem):
        """A stall inside the KNN dispatch makes the tight-deadline KNN
        request late: it is shed (typed Overloaded) while its slack PIP
        batchmate keeps its exact result."""
        _, kx, qpts = knn_problem
        ppts = np.random.default_rng(6).uniform(BBOX[:2], BBOX[2:], (40, 2))
        shed_before = engine.metrics()["shed_deadline"]
        with faults.stalls(0.8, n=1, sites=("knn.distance",)):
            f_knn = engine.submit_knn(qpts(4, seed=3), 2, deadline_s=0.4)
            f_pip = engine.submit(ppts, deadline_s=30.0)
            with pytest.raises(Overloaded) as exc:
                f_knn.result(timeout=60)
            assert exc.value.reason == "deadline"
            pip_rows = np.asarray(f_pip.result(timeout=60))
        solo = np.asarray(engine.join(ppts, timeout=60))
        np.testing.assert_array_equal(pip_rows, solo)
        assert engine.metrics()["shed_deadline"] == shed_before + 1

    def test_poisoned_rows_quarantined_batchmates_exact(self, engine, knn_problem):
        _, kx, qpts = knn_problem
        qb = qpts(6, seed=12)
        qb[1] = (np.nan, 3.0)
        qb[4] = (1e9, -1e9)
        clean = qpts(5, seed=13)
        fb, fc = engine.submit_knn(qb, 3), engine.submit_knn(clean, 3)
        ab, ac = fb.result(timeout=60), fc.result(timeout=60)
        assert np.all(ab.ids[[1, 4]] == -1)
        assert np.all(np.isinf(ab.distance[[1, 4]]))
        good = [0, 2, 3, 5]
        oids, odist = oracle(kx, qb[good], 3)
        np.testing.assert_array_equal(ab.ids[good], oids)
        np.testing.assert_array_equal(bits(ab.distance[good]), bits(odist))
        assert_answer(ac, *oracle(kx, clean, 3))

    def test_exhausted_retries_degrade_on_the_cpu_and_raise_on_the_card_rule(
        self, pip_index, grid, knn_problem
    ):
        """Past the retry budget a CPU engine's KNN answer is flagged
        degraded with the exact values; with the card's rule (no host
        fallback) the request fails with `RetryExhausted`."""
        _, kx, qpts = knn_problem
        q = qpts(4, seed=14)
        fe = KNNFrontend(kx)
        with ServeEngine(pip_index, grid, RES, ladder=BucketLadder(64, 256), bounds=BBOX,
                         knn=fe, default_deadline_s=30.0) as eng:
            with faults.transient_errors(50, sites=("knn.distance",)):
                a = eng.join_knn(q, 3, timeout=60)
            assert a.degraded
            assert_answer(a, *oracle(kx, q, 3))
            fe._degrade_to_host = False
            with faults.transient_errors(50, sites=("knn.distance",)):
                with pytest.raises(RetryExhausted):
                    eng.join_knn(q, 3, timeout=60)
            assert eng.metrics()["failed"] == 1


class TestSwapAndKnobs:
    def test_hot_swap_mid_flight_serves_old_index_to_completion(
        self, pip_index, grid, knn_problem
    ):
        """A KNN request in flight when `hot_swap(knn=...)` lands answers
        from the OLD index (the dispatch snapshot); the next request from
        the new one."""
        _, kx, qpts = knn_problem
        polys, _, _ = square_wkts(np.random.default_rng(21), 50)
        kx2 = build_knn_index(port(RF.st_geomfromwkt(np.array(polys))), grid, RES,
                              device="cpu")
        fe2 = KNNFrontend(kx2, row_ladder=BucketLadder(*ROWS), pair_ladder=BucketLadder(*PAIRS))
        fe2.warmup()
        fe1 = KNNFrontend(kx, row_ladder=BucketLadder(*ROWS), pair_ladder=BucketLadder(*PAIRS))
        fe1.warmup()
        q = qpts(5, seed=33)
        with ServeEngine(pip_index, grid, RES, ladder=BucketLadder(64, 256), bounds=BBOX,
                         max_wait_s=0.01, knn=fe1, default_deadline_s=30.0) as eng:
            eng.warmup()
            with faults.stalls(1.0, n=1, sites=("knn.expand",)):
                fut = eng.submit_knn(q, 2)
                time.sleep(0.15)  # let the batch enter dispatch
                stats = eng.hot_swap(knn=fe2)
                old = fut.result(timeout=60)
            assert stats["knn"]["signatures"] == 14
            assert_answer(old, *oracle(kx, q, 2))
            new = eng.join_knn(q, 2, timeout=60)
            assert_answer(new, *oracle(kx2, q, 2))
            assert not np.array_equal(old.distance, new.distance)
            assert eng.metrics()["cold_compiles"] == 0

    def test_knn_lane_knob_precedence(self, pip_index, grid, knn_problem, monkeypatch):
        """``knn_lane`` resolves explicit > env > profile > default; a
        malformed env value raises."""
        _, kx, _ = knn_problem

        def mk(**kw):
            eng = ServeEngine(pip_index, grid, RES, ladder=BucketLadder(64, 256),
                              bounds=BBOX, knn=kx, **kw)
            lane = eng.knn.lane
            eng.close()
            return lane

        monkeypatch.delenv("MOSAIC_TUNE_KNN_LANE", raising=False)
        assert mk() == "ring"  # default
        assert mk(knn_lane="voronoi") == "voronoi"
        monkeypatch.setenv("MOSAIC_TUNE_KNN_LANE", "voronoi")
        assert mk() == "voronoi"  # env beats default
        assert mk(knn_lane="ring") == "ring"  # explicit beats env
        monkeypatch.setenv("MOSAIC_TUNE_KNN_LANE", "grid")
        with pytest.raises(ValueError, match="knn_lane"):
            mk()
        monkeypatch.delenv("MOSAIC_TUNE_KNN_LANE")
        from mosaic_tpu_torch.tune import TuningProfile

        assert mk(profile=TuningProfile(knn_lane="voronoi")) == "voronoi"
        monkeypatch.setenv("MOSAIC_TUNE_KNN_LANE", "ring")
        assert mk(profile=TuningProfile(knn_lane="voronoi")) == "ring"  # env beats profile

    def test_engine_without_knn_rejects_knn_requests(self, pip_index, grid):
        with ServeEngine(pip_index, grid, RES, ladder=BucketLadder(64, 256),
                         bounds=BBOX) as eng:
            with pytest.raises(RuntimeError, match="no KNN frontend"):
                eng.submit_knn(np.zeros((2, 2)), 2)
            assert "knn_queries" not in eng.metrics()

    def test_submit_knn_refuses_bad_requests(self, engine):
        with pytest.raises(ValueError, match="k must be"):
            engine.submit_knn(np.zeros((2, 2)), 0)
        with pytest.raises(ValueError, match="expected"):
            engine.submit_knn(np.zeros((2, 3)), 2)
        with pytest.raises(ValueError, match="top bucket"):
            engine.submit_knn(np.zeros((2000, 2)), 2)


class TestRouter:
    def test_router_submit_knn_per_tenant(self, pip_index, grid, knn_problem):
        """`ServeRouter.submit_knn` fronts each tenant's KNN engine: the
        tenant with candidates answers the oracle's bits, one without
        refuses, and an evicted tenant revives to answer again."""
        _, kx, qpts = knn_problem
        q = qpts(6, seed=71)
        with ServeRouter(grid, max_resident=1, engine_defaults=dict(
                ladder=BucketLadder(64, 256), bounds=BBOX,
                default_deadline_s=30.0)) as router:
            router.add_tenant("knn", pip_index, RES, knn=kx)
            a = router.join_knn("knn", q, 3, timeout=60)
            assert_answer(a, *oracle(kx, q, 3))
            router.add_tenant("plain", pip_index, RES)  # evicts "knn"
            with pytest.raises(RuntimeError, match="no KNN frontend"):
                router.submit_knn("plain", q, 3)
            again = router.submit_knn("knn", q, 3).result(timeout=60)
            assert_answer(again, *oracle(kx, q, 3))
            m = router.metrics()["tenants"]["knn"]
            assert m["revivals"] >= 1 and m["cold_compiles"] == 0
