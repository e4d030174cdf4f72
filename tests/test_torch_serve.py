"""The port's serving engine (`mosaic_tpu_torch/serve`) on the CPU.

Mirrors `tests/test_serve.py` case for case on its fixture: the custom
grid `GridConf(-180, 180, -90, 90, 2, 10, 10)` at resolution 3 and its
three zones, ladders of 64-4,096, windows of at most 0.05 s and 30 s
deadlines. Each package tessellates and indexes the same WKT itself.
Contracts, each exact (tolerance 0):

- shape discipline: one signature per rung, zero cold compiles over
  random request sizes after `warmup()`, the post-freeze tripwire;
- co-batched answers equal solo answers and the port's `pip_join`
  across bucket boundaries, and equal the REFERENCE `ServeEngine` and
  `pip_join` on the same seeded numpy requests, with cells computed in
  float32 and in float64 by both packages;
- deadline and queue-full sheds with a typed `Overloaded`; poison
  parking that leaves batchmates untouched; retry to success; past the
  retry budget the CPU degrades to `host_join` (`DegradedResult`);
- one connected trace per request across the submit and batcher
  threads;
- what the port does not carry raises a typed error naming its ROADMAP
  entry (the program store, queue 3); ``mesh=`` is carried (a device
  count takes real devices, one on the CPU; the meshed engine cases run
  on logical meshes in `tests/test_torch_mesh.py`); a
  ``knn=`` that is neither a KNN index nor a frontend raises
  ``TypeError`` (KNN serving itself: `tests/test_torch_knn_serve.py`).
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.serve import BucketLadder as RefLadder
from mosaic_tpu.serve import ServeEngine as RefEngine
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.runtime import faults, telemetry
from mosaic_tpu_torch.runtime.errors import DegradedResult, Overloaded
from mosaic_tpu_torch.serve import BucketLadder, ServeEngine
from mosaic_tpu_torch.sql.join import (
    build_chip_index,
    clear_join_caches,
    host_join,
    join_cache_stats,
    pip_join,
)

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
BBOX = (-25.0, -25.0, 35.0, 20.0)
RES = 3
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
    "POLYGON ((20 -10, 30 -10, 30 5, 20 5, 20 -10))",
]


def port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


@pytest.fixture(scope="module")
def grid():
    return CustomIndexSystem(GridConf(*CONF))


@pytest.fixture(scope="module")
def col():
    return wkt.from_wkt(ZONES)


@pytest.fixture(scope="module")
def index(grid, col):
    return build_chip_index(
        tessellate(port_geometry(col), grid, RES, keep_core_geoms=False),
        device="cpu",
    )


def make_engine(index, grid, **kw):
    kw.setdefault("ladder", BucketLadder(64, 4096))
    kw.setdefault("bounds", BBOX)
    kw.setdefault("max_wait_s", 0.01)
    return ServeEngine(index, grid, RES, **kw)


def rand_points(rng, n):
    return rng.uniform(BBOX[:2], BBOX[2:], (n, 2))


def ref_join(pts, grid, index, **kw):
    return np.asarray(
        pip_join(pts, None, grid, RES, chip_index=index, recheck=False,
                 device="cpu", **kw)
    )


class TestCompileDiscipline:
    def test_one_signature_per_bucket_after_warmup(self, index, grid):
        """Over randomized request sizes spanning the ladder, the engine
        introduces ZERO new signatures after warmup()."""
        with make_engine(index, grid) as eng:
            info = eng.warmup()
            assert info["signatures"] == len(eng.ladder.buckets)
            assert sorted(info["rung_seconds"]) == list(eng.ladder.buckets)
            assert info["backend_compiles"] == 0
            rng = np.random.default_rng(7)
            futs = [
                eng.submit(rand_points(rng, int(rng.integers(1, 3000))),
                           deadline_s=30.0)
                for _ in range(40)
            ]
            for f in futs:
                f.result(timeout=30)
            m = eng.metrics()
            assert m["cold_compiles"] == 0, m
            assert m["compile_signatures"] == len(eng.ladder.buckets)
            assert m["completed"] == 40

    def test_cold_dispatch_counts_without_warmup(self, index, grid):
        with make_engine(index, grid) as eng:
            eng.core.freeze()  # arm the tripwire, skip warmup
            with telemetry.capture() as events:
                eng.join(rand_points(np.random.default_rng(0), 10), deadline_s=30.0)
            assert eng.metrics()["cold_compiles"] == 1
            assert any(e["event"] == "serve_compile" for e in events)


class TestBitIdentity:
    def test_cobatched_equals_solo_across_bucket_boundaries(self, index, grid):
        """Concurrent requests coalesced into one device batch return
        EXACTLY the bits of solo execution — sizes straddling bucket
        boundaries included — and equal the offline `pip_join`."""
        rng = np.random.default_rng(3)
        sizes = [63, 64, 65, 1, 255, 256, 257, 100, 1023, 17]
        reqs = [rand_points(rng, n) for n in sizes]
        solo = []
        with make_engine(index, grid, max_wait_s=0.0) as eng1:
            eng1.warmup()
            for pts in reqs:
                solo.append(np.asarray(eng1.join(pts, deadline_s=30.0)))
        with make_engine(index, grid, max_wait_s=0.05) as eng2:
            eng2.warmup()
            futs = [eng2.submit(p, deadline_s=30.0) for p in reqs]
            outs = [np.asarray(f.result(timeout=30)) for f in futs]
            assert eng2.metrics()["batches"] < len(reqs)  # really coalesced
        for pts, a, b in zip(reqs, solo, outs):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, ref_join(pts, grid, index))

    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_equals_reference_engine_and_pip_join(self, index, grid, col, dtype):
        """The same seeded numpy requests through the port's engine and
        the reference's, cells in ``dtype`` in both: equal answers, and
        equal to both packages' `pip_join` (one call on the concatenation,
        split per request: the join is pointwise)."""
        rgrid = RefCustom(RefConf(*CONF))
        rindex = RJ.build_chip_index(
            ref_tessellate(col, rgrid, RES, keep_core_geoms=False)
        )
        rng = np.random.default_rng(41)
        sizes = [63, 65, 1, 200, 257, 17, 500]
        reqs = [rand_points(rng, n) for n in sizes]
        with make_engine(index, grid, max_wait_s=0.05, ladder=BucketLadder(64, 1024),
                         cell_dtype=getattr(torch, dtype)) as eng:
            got = [np.asarray(f.result(timeout=30))
                   for f in [eng.submit(p, deadline_s=30.0) for p in reqs]]
        with RefEngine(rindex, rgrid, RES, ladder=RefLadder(64, 1024), bounds=BBOX,
                       max_wait_s=0.05, cell_dtype=getattr(jnp, dtype)) as reng:
            want = [np.asarray(f.result(timeout=120))
                    for f in [reng.submit(p, deadline_s=120.0) for p in reqs]]
        cat = np.concatenate(reqs)
        cuts = np.cumsum(sizes)[:-1]
        port_pj = np.split(ref_join(cat, grid, index, cell_dtype=getattr(torch, dtype)),
                           cuts)
        ref_pj = np.split(np.asarray(RJ.pip_join(
            cat, None, rgrid, RES, chip_index=rindex, recheck=False,
            cell_dtype=getattr(jnp, dtype))), cuts)
        for g, w, p, r in zip(got, want, port_pj, ref_pj):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(g, r)
        assert sum((g >= 0).sum() for g in got) > 0


class TestDeadlinesAndShedding:
    def test_dispatch_stall_sheds_only_the_late_request(self, index, grid):
        """An injected ``serve.dispatch`` stall delays the shared batch;
        the request whose deadline expires is shed (typed Overloaded),
        its batchmate still gets exact results."""
        with make_engine(index, grid, max_wait_s=0.05) as eng:
            eng.warmup()
            rng = np.random.default_rng(11)
            tight = rand_points(rng, 40)
            slack = rand_points(rng, 50)
            with faults.stalls(0.4, n=1, sites=("serve.dispatch",)):
                f_tight = eng.submit(tight, deadline_s=0.1)
                f_slack = eng.submit(slack, deadline_s=30.0)
                with pytest.raises(Overloaded) as exc:
                    f_tight.result(timeout=30)
                assert exc.value.reason == "deadline"
                assert exc.value.deadline_s == pytest.approx(0.1)
                assert exc.value.elapsed_s >= 0.1
                out = np.asarray(f_slack.result(timeout=30))
            np.testing.assert_array_equal(out, ref_join(slack, grid, index))
            m = eng.metrics()
            assert m["shed"] == 1 and m["shed_deadline"] == 1
            assert m["completed"] == 1

    def test_expired_before_dispatch_is_shed_without_device_work(self, index, grid):
        with make_engine(index, grid, max_wait_s=0.05) as eng:
            eng.warmup()
            batches_before = eng.metrics()["batches"]
            f = eng.submit(rand_points(np.random.default_rng(2), 10), deadline_s=0.0)
            with pytest.raises(Overloaded) as exc:
                f.result(timeout=30)
            assert exc.value.reason == "deadline"
            assert eng.metrics()["batches"] == batches_before

    def test_queue_full_sheds_with_typed_overloaded(self, index, grid):
        """With the queue at capacity behind a stalled dispatch, admission
        refuses instead of queueing without bound."""
        with make_engine(index, grid, queue_capacity=2, max_wait_s=0.0) as eng:
            eng.warmup()
            rng = np.random.default_rng(5)
            with telemetry.capture() as events, faults.stalls(
                0.4, n=1, sites=("serve.dispatch",)
            ):
                futs = [eng.submit(rand_points(rng, 8), deadline_s=30.0)]
                time.sleep(0.05)  # the worker is in the stalled dispatch
                shed = 0
                for _ in range(6):
                    try:
                        futs.append(eng.submit(rand_points(rng, 8), deadline_s=30.0))
                    except Overloaded as e:
                        assert e.reason == "queue_full" and e.capacity == 2
                        shed += 1
                assert shed >= 1
                for f in futs:
                    f.result(timeout=30)
            assert eng.metrics()["shed"] >= shed
            assert any(
                e["event"] == "serve_shed" and e.get("reason") == "queue_full"
                for e in events
            )

    def test_close_sheds_queued_requests_with_shutdown(self, index, grid):
        eng = make_engine(index, grid, max_wait_s=0.0)
        with faults.stalls(0.3, n=1, sites=("serve.dispatch",)):
            first = eng.submit(rand_points(np.random.default_rng(4), 8), deadline_s=30.0)
            time.sleep(0.05)
            queued = eng.submit(rand_points(np.random.default_rng(5), 8), deadline_s=30.0)
            eng.close()
        first.result(timeout=30)
        with pytest.raises(Overloaded) as exc:
            queued.result(timeout=30)
        assert exc.value.reason == "shutdown"
        with pytest.raises(RuntimeError, match="closed"):
            eng.submit(np.zeros((1, 2)))


class TestQuarantine:
    def test_poison_request_leaves_batchmates_untouched(self, index, grid):
        """A co-batched request carrying NaN/out-of-bounds rows is parked;
        its batchmates' bits equal a poison-free run and the poisoned rows
        answer -1."""
        rng = np.random.default_rng(13)
        clean_a = rand_points(rng, 120)
        clean_b = rand_points(rng, 77)
        poison = rand_points(rng, 60)
        poison[5] = np.nan
        poison[17, 0] = np.inf
        poison[33] = (1e6, 1e6)  # far outside BBOX bounds
        with make_engine(index, grid, max_wait_s=0.05) as eng:
            eng.warmup()
            fa = eng.submit(clean_a, deadline_s=30.0)
            fp = eng.submit(poison, deadline_s=30.0)
            fb = eng.submit(clean_b, deadline_s=30.0)
            out_a = np.asarray(fa.result(timeout=30))
            out_p = np.asarray(fp.result(timeout=30))
            out_b = np.asarray(fb.result(timeout=30))
            m = eng.metrics()
        for pts, out in ((clean_a, out_a), (clean_b, out_b)):
            np.testing.assert_array_equal(out, ref_join(pts, grid, index))
        assert out_p[5] == -1 and out_p[17] == -1 and out_p[33] == -1
        good = np.ones(60, bool)
        good[[5, 17, 33]] = False
        np.testing.assert_array_equal(out_p[good], ref_join(poison[good], grid, index))
        assert m["quarantined"] == 3
        assert m["poisoned_requests"] == 1

    def test_corrupt_injection_at_admit_site(self, index, grid):
        """`faults.corrupt_batches` at serve.admit poisons rows before
        scrubbing — exactly those rows are parked."""
        with make_engine(index, grid) as eng:
            eng.warmup()
            with faults.corrupt_batches(4, sites=("serve.admit",)):
                out = np.asarray(eng.join(
                    rand_points(np.random.default_rng(1), 30), deadline_s=30.0))
            assert (out[:4] == -1).all()
            assert eng.metrics()["quarantined"] == 4

    def test_park_point_hits_no_indexed_cell(self, index, grid):
        with make_engine(index, grid, bounds=None) as eng:
            park = eng._derive_park(np.array([[np.nan, 0.0], [1.0, 2.0]]))
        assert np.isfinite(park).all()
        assert ref_join(park[None], grid, index)[0] == -1


class TestResilience:
    def test_transient_dispatch_failure_retries_to_success(self, index, grid):
        pts = rand_points(np.random.default_rng(21), 90)
        with make_engine(index, grid) as eng:
            eng.warmup()
            with telemetry.capture() as events, faults.transient_errors(
                1, sites=("serve.dispatch",)
            ):
                out = np.asarray(eng.join(pts, deadline_s=30.0))
        np.testing.assert_array_equal(out, ref_join(pts, grid, index))
        assert any(e["event"] == "transient_retry" for e in events)
        assert not isinstance(out, DegradedResult)

    def test_retry_exhaustion_degrades_to_host_oracle_on_the_cpu(self, index, grid):
        pts = rand_points(np.random.default_rng(23), 70)
        with make_engine(index, grid) as eng:
            eng.warmup()
            with telemetry.capture() as events, faults.transient_errors(
                10, sites=("serve.dispatch",)
            ):
                out = eng.join(pts, deadline_s=30.0)
        assert isinstance(out, DegradedResult)
        np.testing.assert_array_equal(np.asarray(out), host_join(pts, index.host, grid, RES))
        np.testing.assert_array_equal(np.asarray(out), ref_join(pts, grid, index))
        assert eng.metrics()["degraded"] == 1
        assert any(e["event"] == "degraded" for e in events)

    def test_retry_attempts_knob_degrades_after_two_on_the_cpu(
        self, index, grid, monkeypatch
    ):
        """The reference's case (`tests/test_serve.py`): under
        ``MOSAIC_RETRY_ATTEMPTS=2`` the dispatch degrades after two
        attempts."""
        monkeypatch.setenv("MOSAIC_RETRY_ATTEMPTS", "2")
        monkeypatch.setenv("MOSAIC_RETRY_BASE_S", "0.01")
        pts = rand_points(np.random.default_rng(23), 70)
        with make_engine(index, grid) as eng:
            eng.warmup()
            with telemetry.capture() as events, faults.transient_errors(
                10, sites=("serve.dispatch",)
            ):
                out = eng.join(pts, deadline_s=30.0)
        assert isinstance(out, DegradedResult)
        assert out.attempts == 2
        np.testing.assert_array_equal(np.asarray(out), ref_join(pts, grid, index))
        assert eng.metrics()["degraded"] == 1
        assert [e["attempt"] for e in events if e["event"] == "transient_retry"] == [1, 2]

    def test_batch_fault_site_fails_the_batch_futures(self, index, grid):
        from mosaic_tpu_torch.runtime.errors import TransientDeviceError

        with make_engine(index, grid) as eng:
            with faults.transient_errors(1, sites=("serve.batch",)):
                f = eng.submit(rand_points(np.random.default_rng(2), 5), deadline_s=30.0)
                with pytest.raises(TransientDeviceError):
                    f.result(timeout=30)
            assert eng.metrics()["failed"] == 1


class TestHotSwap:
    def test_hot_swap_rebinds_a_warmed_core(self, index, grid, col):
        other = build_chip_index(
            tessellate(port_geometry(wkt.from_wkt(
                ["POLYGON ((-24 -24, 34 -24, 34 19, -24 19, -24 -24))"])),
                grid, RES, keep_core_geoms=False),
            device="cpu",
        )
        pts = rand_points(np.random.default_rng(9), 100)
        with make_engine(index, grid, ladder=BucketLadder(64, 256)) as eng:
            eng.warmup()
            np.testing.assert_array_equal(eng.join(pts, deadline_s=30.0),
                                          ref_join(pts, grid, index))
            with telemetry.capture() as events:
                stats = eng.hot_swap(other)
            assert stats["buckets"] == 3 and eng.core.warmed
            assert any(e["event"] == "serve_swap" for e in events)
            np.testing.assert_array_equal(eng.join(pts, deadline_s=30.0),
                                          ref_join(pts, grid, other))
            assert eng.metrics()["cold_compiles"] == 0


class TestClose:
    def test_close_frees_the_cores_graphs_without_a_collection(self, index, grid):
        """A closed engine may outlive its last reference in a cycle until
        a full collection; its core's graphs (captured on the card; a
        stand-in here) are freed at close, not by that collection."""
        import gc
        import weakref

        class Graph:
            pass

        eng = make_engine(index, grid, ladder=BucketLadder(64, 256))
        eng.warmup()
        graph = Graph()
        eng.core._graphs[64] = {"graph": graph}
        freed = weakref.ref(graph)
        del graph
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            eng.close()
            assert freed() is None and eng.core._graphs == {}
        finally:
            if gc_was_enabled:
                gc.enable()


    def test_hot_swap_releases_the_replaced_core_after_its_batch(self, index, grid):
        """A hot_swap frees the replaced core's graphs, but only once the
        batch in flight on it has returned: the batch that took the old
        core before the swap dispatches on it after the rebind, and a
        release before then would make it capture its rung again."""
        import threading

        eng = make_engine(index, grid, ladder=BucketLadder(64, 256))
        try:
            eng.warmup()
            old = eng.core
            entered, go, calls = threading.Event(), threading.Event(), []
            real_exec, real_release = old.execute_resilient, old.release_graphs

            def held(*a, **k):
                entered.set()
                assert go.wait(30)
                return real_exec(*a, **k)

            def spy():
                calls.append(time.monotonic())
                real_release()

            old.execute_resilient, old.release_graphs = held, spy
            pts = rand_points(np.random.default_rng(4), 50)
            fut = eng.submit(pts, deadline_s=30.0)
            assert entered.wait(30)
            eng.hot_swap()
            assert eng.core is not old and calls == []  # the batch holds it
            t_go = time.monotonic()
            go.set()
            np.testing.assert_array_equal(fut.result(timeout=30),
                                          ref_join(pts, grid, index))
            deadline = time.monotonic() + 10
            while not calls and time.monotonic() < deadline:
                time.sleep(0.005)
            assert len(calls) == 1 and calls[0] >= t_go
            # with no batch in flight the swap releases at once
            mid = eng.core
            mid_calls = []
            mid.release_graphs = lambda: mid_calls.append(1)
            eng.hot_swap()
            assert mid_calls == [1]
            np.testing.assert_array_equal(eng.join(pts, deadline_s=30.0),
                                          ref_join(pts, grid, index))
            assert len(calls) == 1 and eng.metrics()["cold_compiles"] == 0
        finally:
            eng.close()

    def test_router_swap_releases_the_replaced_core(self, index, grid):
        from mosaic_tpu_torch.serve import ServeRouter

        router = ServeRouter(grid, engine_defaults={
            "ladder": BucketLadder(64, 256), "bounds": BBOX, "max_wait_s": 0.01})
        try:
            router.add_tenant("a", index, RES)
            old = router._tenants["a"].engine.core
            calls = []
            old.release_graphs = lambda: calls.append(1)
            router.swap("a", index)
            assert calls == [1]
        finally:
            router.close()


class TestJoinCacheHatch:
    def test_stats_and_clear(self):
        with telemetry.capture() as events:
            stats = join_cache_stats()
            cleared = clear_join_caches()
        assert stats["cells_prog"]["maxsize"] == 64
        assert cleared["cells_prog"]["currsize"] >= 0
        assert join_cache_stats(emit=False)["cells_prog"]["currsize"] == 0
        names = [e["event"] for e in events]
        assert "join_cache_stats" in names
        assert "join_caches_cleared" in names


def trace_summary(events) -> dict:
    """{trace_id: {"roots", "orphans"}} over the span events: a root has
    no parent, an orphan names a parent that no span of its trace has."""
    spans = [e for e in events if e["event"] == "span"]
    out = {}
    for tid in {s["trace_id"] for s in spans}:
        mine = [s for s in spans if s["trace_id"] == tid]
        ids = {s["span_id"] for s in mine}
        out[tid] = {
            "roots": sum(s["parent_id"] is None for s in mine),
            "orphans": [s["name"] for s in mine
                        if s["parent_id"] is not None and s["parent_id"] not in ids],
        }
    return out


class TestTracing:
    def test_one_request_is_one_connected_trace(self, index, grid):
        """A request submitted on the test thread and dispatched on the
        batcher thread yields ONE trace: every span shares the trace_id,
        parent links resolve, no orphans."""
        with make_engine(index, grid) as eng:
            eng.warmup()
            with telemetry.capture() as events:
                out = eng.join(rand_points(np.random.default_rng(31), 25),
                               deadline_s=30.0)
        assert np.asarray(out).shape == (25,)
        spans = [e for e in events if e["event"] == "span"]
        by_name = {s["name"]: s for s in spans}
        assert set(by_name) >= {
            "serve.request", "serve.admit", "serve.batch", "serve.dispatch",
        }
        summ = trace_summary(events)
        assert len(summ) == 1, f"expected ONE trace, got {summ}"
        ((tid, t),) = summ.items()
        assert t["roots"] == 1 and not t["orphans"], t
        root = by_name["serve.request"]
        assert root["parent_id"] is None and root["trace_id"] == tid
        assert by_name["serve.admit"]["parent_id"] == root["span_id"]
        assert by_name["serve.batch"]["parent_id"] == root["span_id"]
        assert by_name["serve.dispatch"]["parent_id"] == by_name["serve.batch"]["span_id"]
        req_ev = next(e for e in events if e["event"] == "serve_request")
        assert req_ev["trace_id"] == tid

    def test_batchmates_keep_their_own_traces(self, index, grid):
        with make_engine(index, grid, max_wait_s=0.05) as eng:
            eng.warmup()
            rng = np.random.default_rng(33)
            with telemetry.capture() as events:
                futs = [eng.submit(rand_points(rng, 30), deadline_s=30.0)
                        for _ in range(3)]
                for f in futs:
                    f.result(timeout=30)
            assert eng.metrics()["batches"] < 3  # really coalesced
        roots = [e for e in events
                 if e["event"] == "span" and e["name"] == "serve.request"]
        assert len(roots) == 3
        assert len({r["trace_id"] for r in roots}) == 3
        req_evs = [e for e in events if e["event"] == "serve_request"]
        assert sorted(e["trace_id"] for e in req_evs) == sorted(
            r["trace_id"] for r in roots)

    def test_retry_attaches_to_the_request_trace(self, index, grid):
        with make_engine(index, grid) as eng:
            eng.warmup()
            with telemetry.capture() as events, faults.transient_errors(
                1, sites=("serve.dispatch",)
            ):
                eng.join(rand_points(np.random.default_rng(35), 40), deadline_s=30.0)
        root = next(e for e in events
                    if e["event"] == "span" and e["name"] == "serve.request")
        retry = next(e for e in events if e["event"] == "transient_retry")
        assert retry["trace_id"] == root["trace_id"]
        dispatch = next(e for e in events
                        if e["event"] == "span" and e["name"] == "serve.dispatch")
        assert dispatch["trace_id"] == root["trace_id"]

    def test_shed_request_trace_records_the_reason(self, index, grid):
        with make_engine(index, grid, max_wait_s=0.05) as eng:
            eng.warmup()
            with telemetry.capture() as events:
                f = eng.submit(rand_points(np.random.default_rng(37), 10),
                               deadline_s=0.0)
                with pytest.raises(Overloaded):
                    f.result(timeout=30)
        root = next(e for e in events
                    if e["event"] == "span" and e["name"] == "serve.request")
        assert root["error"] == "Overloaded"
        assert root["reason"] == "deadline"
        shed = next(e for e in events if e["event"] == "serve_shed")
        assert shed["trace_id"] == root["trace_id"]


class TestSummarize:
    def test_percentiles(self):
        events = [
            {"event": "serve_request", "seconds": s}
            for s in (0.01, 0.02, 0.03, 0.04, 0.10)
        ] + [{"event": "other", "seconds": 99.0}, {"event": "serve_request"}]
        s = telemetry.summarize(events, event="serve_request")
        assert s["count"] == 5
        assert s["p50"] == 0.03
        assert s["max"] == 0.10
        assert s["p99"] == 0.10


class TestNotPorted:
    # KNN serving is ported (tests/test_torch_knn_serve.py): the cases of
    # its two refusals went with them; the ids keep the other cases' names
    # mesh= is ported: its case (it raised NotImplementedError naming item
    # 12 before) now asks for 2 real devices, which the CPU does not have,
    # and a logical 2-device mesh serves the single-device answers.
    # program_store= is ported: its case (it raised naming queue 3 before)
    # binds a store under the test's directory, which a second engine
    # warms from
    @pytest.mark.parametrize("kw,exc,item", [
        pytest.param(dict(mesh=2), ValueError, "devices", id="kw3-item 12"),
        pytest.param(dict(program_store="tmp_path"), None, "queue 3", id="kw4-queue 3"),
    ])
    def test_engine_arguments_raise_naming_their_item(self, index, grid, kw, exc, item,
                                                      tmp_path):
        if "program_store" in kw:
            pts = rand_points(np.random.default_rng(4), 300)
            with make_engine(index, grid, program_store=str(tmp_path)) as eng:
                assert eng.warmup()["aot"]["exported"] == 2 * len(eng.ladder.buckets)
            with make_engine(index, grid, program_store=str(tmp_path)) as eng:
                w = eng.warmup()
                assert w["aot"] == {"loaded": 2 * len(eng.ladder.buckets),
                                    "exported": 0, "fallback": 0}
                np.testing.assert_array_equal(
                    eng.join(pts, deadline_s=30.0), ref_join(pts, grid, index)
                )
            return
        with pytest.raises(exc, match=item):
            make_engine(index, grid, **kw)
        if "mesh" in kw:
            from mosaic_tpu_torch.dispatch import data_mesh

            pts = rand_points(np.random.default_rng(3), 300)
            mesh = data_mesh(devices=["cpu"] * kw["mesh"])
            with make_engine(index, grid, mesh=mesh) as eng:
                assert eng.mesh is mesh and eng.core.mesh is mesh
                np.testing.assert_array_equal(
                    eng.join(pts, deadline_s=30.0), ref_join(pts, grid, index)
                )

    def test_knn_submit_and_swap(self, index, grid):
        with make_engine(index, grid) as eng:
            with pytest.raises(RuntimeError, match="no KNN frontend"):
                eng.submit_knn(np.zeros((2, 2)), 3)
            with pytest.raises(TypeError, match="KNNIndex or a KNNFrontend"):
                eng.hot_swap(knn=object())
        with pytest.raises(TypeError, match="KNNIndex or a KNNFrontend"):
            make_engine(index, grid, knn=object())
