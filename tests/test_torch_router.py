"""The port's multi-tenant router (`mosaic_tpu_torch/serve/router.py`)
and the dispatch core's resident-core cache, on the CPU.

Mirrors `tests/test_router.py` on its fixture (the custom grid
`GridConf(-180, 180, -90, 90, 2, 10, 10)` at resolution 3, index A's
three zones and index B's one box). The reference's router tests bind an
AOT program store; these run without one, so their revival contract is
"zero nvcc builds and, after its warmup, zero cold compiles"; a revival
that warms from a bound store is `TestNotPorted` here and
`tests/test_torch_programs.py`. Contracts:

- per-tenant engines: an aggressor flooding its own tiny quota cannot
  shed a single victim request, and sheds are accounted to the tenant
  that saw them;
- bounded residency: health-aware, occupancy-aware LRU eviction and
  transparent revival with bit-identical answers;
- swap under load: every answer equals one of the two indexes' answers,
  the answer after the swap the new one's, with zero cold compiles;
- the ``router.admit``, ``router.evict`` and ``router.swap`` fault sites;
- `_CoreCache` order and stats; the health monitor's state machine;
- what once raised is carried: the program store and tenant profiles.
"""

import threading
import time

import numpy as np
import pytest

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.dispatch import BucketLadder, backend_compiles, cache_stats, cache_view
from mosaic_tpu_torch.dispatch.core import _CoreCache
from mosaic_tpu_torch.obs import health, metrics
from mosaic_tpu_torch.runtime import faults, telemetry
from mosaic_tpu_torch.runtime.errors import Overloaded, TransientDeviceError
from mosaic_tpu_torch.serve import ServeRouter, resolve_max_resident
from mosaic_tpu_torch.sql.join import build_chip_index, pip_join

BBOX = (-25.0, -25.0, 35.0, 20.0)
RES = 3


def port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


@pytest.fixture(scope="module")
def grid():
    return CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))


def _index(grid, wkts):
    col = port_geometry(wkt.from_wkt(wkts))
    return build_chip_index(tessellate(col, grid, RES, keep_core_geoms=False),
                            device="cpu")


@pytest.fixture(scope="module")
def index_a(grid):
    return _index(grid, [
        "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))",
        "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
        "POLYGON ((20 -10, 30 -10, 30 5, 20 5, 20 -10))",
    ])


@pytest.fixture(scope="module")
def index_b(grid):
    # deliberately DIFFERENT coverage so swapped answers are
    # distinguishable from index_a's
    return _index(grid, ["POLYGON ((-24 -24, 34 -24, 34 19, -24 19, -24 -24))"])


def make_router(grid, **kw):
    kw.setdefault("engine_defaults", {
        "ladder": BucketLadder(64, 256),
        "bounds": BBOX,
        "max_wait_s": 0.01,
    })
    kw.setdefault("health_monitor", health.HealthMonitor())
    return ServeRouter(grid, **kw)


def rand_points(rng, n):
    return rng.uniform(BBOX[:2], BBOX[2:], (n, 2))


def ref_join(pts, grid, index):
    return np.asarray(pip_join(pts, None, grid, RES, chip_index=index,
                               recheck=False, device="cpu"))


def settle(futures):
    """Drain a list of futures, swallowing sheds."""
    for f in futures:
        try:
            f.result(timeout=10)
        except Overloaded:
            pass


class TestRouterBasics:
    def test_unknown_tenant_is_keyerror(self, grid):
        with make_router(grid) as router:
            with pytest.raises(KeyError, match="unknown tenant"):
                router.submit("ghost", np.zeros((4, 2)))
            with pytest.raises(KeyError):
                router.evict("ghost")
            with pytest.raises(KeyError):
                router.swap("ghost")

    def test_duplicate_tenant_rejected(self, grid, index_a):
        with make_router(grid) as router:
            router.add_tenant("acme", index_a, RES, warm=False)
            with pytest.raises(ValueError, match="already registered"):
                router.add_tenant("acme", index_a, RES, warm=False)
            assert router.tenants() == ["acme"]

    def test_resolve_max_resident_precedence(self, monkeypatch):
        monkeypatch.delenv("MOSAIC_SERVE_TENANTS", raising=False)
        assert resolve_max_resident(None) == 4
        assert resolve_max_resident(2) == 2
        monkeypatch.setenv("MOSAIC_SERVE_TENANTS", "7")
        assert resolve_max_resident(None) == 7
        assert resolve_max_resident(1) == 1  # explicit beats env
        with pytest.raises(ValueError, match=">= 1"):
            resolve_max_resident(0)

    def test_closed_router_refuses(self, grid, index_a):
        router = make_router(grid)
        router.add_tenant("acme", index_a, RES, warm=False)
        router.close()
        with pytest.raises(RuntimeError, match="closed"):
            router.submit("acme", np.zeros((4, 2)))


class TestResidencyAndRevival:
    def test_lru_evict_and_transparent_revive(self, grid, index_a):
        """max_resident=1: registering B evicts A; submitting to A revives
        it (evicting B) and answers bit-identically."""
        pts = rand_points(np.random.default_rng(5), 100)
        ref = ref_join(pts, grid, index_a)
        with make_router(grid, max_resident=1) as router:
            router.add_tenant("a", index_a, RES)
            router.add_tenant("b", index_a, RES)
            m = router.metrics()
            assert m["resident"] == 1 and m["evictions"] == 1
            assert not m["tenants"]["a"]["resident"]
            assert m["tenants"]["b"]["resident"]
            np.testing.assert_array_equal(router.join("a", pts), ref)
            m = router.metrics()
            assert m["tenants"]["a"]["resident"]
            assert not m["tenants"]["b"]["resident"]
            assert m["tenants"]["a"]["revivals"] == 2
            assert m["evictions"] == 2

    def test_revival_builds_nothing_and_compiles_nothing(self, grid, index_a):
        """A revival's warmup starts no nvcc build, and after it the
        revived engine serves with zero cold compiles."""
        pts = rand_points(np.random.default_rng(6), 200)
        with make_router(grid, max_resident=1) as router:
            router.add_tenant("a", index_a, RES)
            router.add_tenant("b", index_a, RES)  # evicts a
            c0 = backend_compiles()
            with telemetry.capture() as events:
                out = router.join("a", pts)  # revives a
            assert backend_compiles() - c0 == 0
            warm = [e for e in events if e["event"] == "serve_warmup"]
            assert len(warm) == 1 and warm[0]["backend_compiles"] == 0
            assert warm[0]["signatures"] == 3
            np.testing.assert_array_equal(out, ref_join(pts, grid, index_a))
            assert router.metrics()["tenants"]["a"]["cold_compiles"] == 0

    def test_explicit_evict_keeps_registration(self, grid, index_a):
        pts = rand_points(np.random.default_rng(6), 64)
        with make_router(grid) as router:
            router.add_tenant("a", index_a, RES)
            router.evict("a")
            assert not router.metrics()["tenants"]["a"]["resident"]
            assert "shed" in router.metrics()["tenants"]["a"]  # last-known
            np.testing.assert_array_equal(router.join("a", pts),
                                          ref_join(pts, grid, index_a))
            snap = metrics.snapshot()
            assert snap["serve.router_evictions"]["kind"] == "counter"

    def test_unhealthy_tenant_is_evicted_first(self, grid, index_a):
        """The eviction order reads the health monitor: a tenant shedding
        most of its admissions loses residency before a healthy, older
        one."""
        mon = health.HealthMonitor(min_events=2)
        with make_router(grid, max_resident=2, health_monitor=mon) as router:
            router.add_tenant("old", index_a, RES)
            router.add_tenant("sick", index_a, RES)
            now = time.monotonic()
            for i in range(6):
                mon.observer({"event": "router_shed", "tenant": "sick",
                              "ts_mono": now + i * 1e-3})
            mon.evaluate(now + 0.01)
            assert mon.tenant_state("sick") == "unhealthy"
            router.add_tenant("new", index_a, RES)
            m = router.metrics()["tenants"]
            assert m["old"]["resident"] and not m["sick"]["resident"]
            assert m["sick"]["health"] == "unhealthy"


class TestIsolation:
    def test_aggressor_flood_cannot_touch_victim(self, grid, index_a):
        """Tenant A floods its own tiny quota while tenant B serves
        sequentially: B sees ZERO shed and every B answer is exact."""
        rng = np.random.default_rng(7)
        flood_pts = rand_points(rng, 200)
        victim_pts = rand_points(rng, 100)
        ref = ref_join(victim_pts, grid, index_a)
        with make_router(grid, max_resident=2) as router:
            router.add_tenant("aggressor", index_a, RES, queue_capacity=2)
            router.add_tenant("victim", index_a, RES, queue_capacity=32)
            futures, stop = [], threading.Event()

            def flood():
                while not stop.is_set():
                    try:
                        futures.append(router.submit("aggressor", flood_pts,
                                                     deadline_s=0.05))
                    except Overloaded:
                        pass

            th = threading.Thread(target=flood, daemon=True)  # lint: thread-context-adoption-ok (flood thread asserts only router-side counters; no telemetry/fault context needed)
            th.start()
            try:
                for _ in range(15):
                    np.testing.assert_array_equal(
                        router.join("victim", victim_pts, deadline_s=30.0), ref)
            finally:
                stop.set()
                th.join(timeout=10)
            settle(futures)
            m = router.metrics()["tenants"]
            assert m["aggressor"]["shed_admit_router"] > 0
            assert m["victim"]["shed_admit_router"] == 0
            assert m["victim"]["shed"] == 0
            assert m["victim"]["cold_compiles"] == 0

    def test_simultaneous_overload_accounts_per_tenant(self, grid, index_a):
        """Both tenants overload at once: each tenant's sheds land in its
        own ledger, matching what its own caller observed."""
        pts = rand_points(np.random.default_rng(8), 200)
        observed = {"x": 0, "y": 0}
        reasons = set()
        with make_router(grid, max_resident=2) as router:
            for name in observed:
                router.add_tenant(name, index_a, RES, queue_capacity=2)

            def flood(name):
                futures = []
                for _ in range(40):
                    try:
                        futures.append(router.submit(name, pts, deadline_s=0.05))
                    except Overloaded as e:
                        observed[name] += 1
                        reasons.add(e.reason)
                settle(futures)

            threads = [
                threading.Thread(target=flood, args=(n,))  # lint: thread-context-adoption-ok (per-tenant flood asserts caller-observed counts only)
                for n in observed
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            m = router.metrics()["tenants"]
            for name, n_observed in observed.items():
                assert n_observed > 0, f"{name} never overloaded"
                assert m[name]["shed_admit_router"] == n_observed
            assert reasons <= {"queue_full", "deadline"}


class TestSwapUnderLoad:
    def test_swap_mid_stream_is_bit_exact(self, grid, index_a, index_b):
        """hot_swap through the router while submits stream: every answer
        matches one of the two snapshots (never a torn mix), the answer
        after the swap is the new index's, with zero cold compiles."""
        pts = rand_points(np.random.default_rng(9), 100)
        ref_a = ref_join(pts, grid, index_a)
        ref_b = ref_join(pts, grid, index_b)
        assert not np.array_equal(ref_a, ref_b)  # the swap must be observable
        with make_router(grid) as router:
            router.add_tenant("t", index_a, RES, queue_capacity=128)
            futures, stop = [], threading.Event()

            def stream():
                while not stop.is_set():
                    try:
                        futures.append(router.submit("t", pts))
                    except Overloaded:
                        pass
                    time.sleep(0.002)

            th = threading.Thread(target=stream, daemon=True)  # lint: thread-context-adoption-ok (load generator; results compared on the caller thread)
            th.start()
            try:
                time.sleep(0.05)
                stats = router.swap("t", index_b)
            finally:
                stop.set()
                th.join(timeout=10)
            assert stats["buckets"] == 3  # the new core ran every rung
            results = []
            for f in futures:
                try:
                    results.append(np.asarray(f.result(timeout=10)))
                except Overloaded:
                    pass
            assert results, "stream produced no answers"
            for r in results:
                assert np.array_equal(r, ref_a) or np.array_equal(r, ref_b), (
                    "answer matches neither snapshot — torn swap")
            np.testing.assert_array_equal(router.join("t", pts), ref_b)
            assert router.metrics()["tenants"]["t"]["cold_compiles"] == 0


class TestFaultSites:
    def test_router_admit_site_injects(self, grid, index_a):
        with make_router(grid) as router:
            router.add_tenant("a", index_a, RES)
            pts = np.zeros((4, 2))
            with faults.transient_errors(1, sites=("router.admit",)):
                with pytest.raises(TransientDeviceError):
                    router.submit("a", pts)
            router.join("a", pts)  # budget consumed; serving resumes

    def test_router_evict_site_injects(self, grid, index_a):
        with make_router(grid) as router:
            router.add_tenant("a", index_a, RES)
            with faults.transient_errors(1, sites=("router.evict",)):
                with pytest.raises(TransientDeviceError):
                    router.evict("a")
            assert router.metrics()["tenants"]["a"]["resident"]
            router.evict("a")
            assert not router.metrics()["tenants"]["a"]["resident"]

    def test_router_swap_site_failure_keeps_old_snapshot(self, grid, index_a, index_b):
        """A fault at router.swap leaves the tenant serving the OLD index
        bit for bit — swap is all-or-nothing."""
        pts = rand_points(np.random.default_rng(10), 64)
        ref_a = ref_join(pts, grid, index_a)
        with make_router(grid) as router:
            router.add_tenant("a", index_a, RES)
            with faults.transient_errors(1, sites=("router.swap",)):
                with pytest.raises(TransientDeviceError):
                    router.swap("a", index_b)
            np.testing.assert_array_equal(router.join("a", pts), ref_a)
            router.evict("a")  # a revival still builds on the old index
            np.testing.assert_array_equal(router.join("a", pts), ref_a)


class TestNotPorted:
    def test_program_store_names_queue_3(self, grid, index_a, tmp_path):
        """``program_store=`` is ported (it raised naming queue 3 before):
        each tenant's engine shares the router's store, and a revival
        warms from it, building nothing."""
        pts = rand_points(np.random.default_rng(12), 64)
        with make_router(grid, max_resident=1, program_store=str(tmp_path)) as router:
            assert router.add_tenant("a", index_a, RES)["aot"]["exported"] == 6
            stats = router.add_tenant("b", index_a, RES)
            assert stats["aot"] == {"loaded": 6, "exported": 0, "fallback": 0}
            assert stats["backend_compiles"] == 0
            np.testing.assert_array_equal(router.join("a", pts),
                                          ref_join(pts, grid, index_a))
            assert router._tenants["a"].engine.program_store is router.program_store

    @pytest.mark.parametrize("kw", [dict(probe="adaptive"), dict(root=True)],
                             ids=["profile", "profile_root"])
    def test_tenant_profiles_tune_the_engine(self, grid, index_a, tmp_path, kw):
        """``add_tenant(profile=)`` and ``(profile_root=)`` (ported with
        the tune slice; tests/test_torch_tune.py holds the store's
        refusals): the tenant's engine takes the profile's probe and its
        answers stay equal to `pip_join`."""
        from mosaic_tpu_torch.tune import ProfileStore, TuningProfile, index_fingerprint

        prof = TuningProfile(probe="adaptive")
        if kw.pop("root", False):
            ProfileStore(str(tmp_path)).save(prof, fingerprint=index_fingerprint(index_a))
            kw = {"profile_root": str(tmp_path)}
        else:
            kw = {"profile": prof}
        pts = np.random.default_rng(4).uniform(BBOX[:2], BBOX[2:], (200, 2))
        with make_router(grid) as router:
            router.add_tenant("a", index_a, RES, **kw)
            assert router.tenants() == ["a"]
            assert router._tenants["a"].engine.probe == "adaptive"
            got = np.asarray(router.join("a", pts))
        want = pip_join(pts, None, grid, RES, chip_index=index_a,
                        recheck=False, device="cpu")
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))

    def test_epochs_and_knn_name_their_items(self, grid, index_a):
        from mosaic_tpu_torch.index import EpochalIndex

        with make_router(grid) as router:
            router.add_tenant("a", index_a, RES, warm=False)
            # epochs and their re-profiling are ported
            # (tests/test_torch_epoch.py, tests/test_torch_tune.py)
            assert callable(EpochalIndex.reprofile)
            # KNN is ported: a tenant whose engine has no KNN frontend
            # refuses KNN requests (tests/test_torch_knn_serve.py serves them)
            with pytest.raises(RuntimeError, match="no KNN frontend"):
                router.submit_knn("a", np.zeros((2, 2)), 3)


# --------------------------------------------------- _CoreCache surface

class _FakeCore:
    def __init__(self, warmed):
        self.warmed = warmed


class TestCoreCache:
    def test_cold_evicted_before_warm_regardless_of_recency(self):
        c = _CoreCache(maxsize=2)
        warm, cold = _FakeCore(True), _FakeCore(False)
        c.put("warm", warm)
        c.put("cold", cold)  # most recent, but never warmed
        c.put("new", _FakeCore(True))
        assert c.get("warm") is warm
        assert c.get("cold") is None
        assert c.extra_stats()["evictions"] == 1

    def test_lru_order_among_warm(self):
        c = _CoreCache(maxsize=2)
        a, b = _FakeCore(True), _FakeCore(True)
        c.put("a", a)
        c.put("b", b)
        c.get("a")  # refresh: b becomes the LRU
        c.put("c", _FakeCore(True))
        assert c.get("b") is None
        assert c.get("a") is a

    def test_lru_cache_protocol_and_extra_stats(self):
        c = _CoreCache(maxsize=4)
        c.put("k", _FakeCore(True))
        c.get("k")
        c.get("k")
        info = c.cache_info()
        assert (info.hits, info.misses) == (2, 1)
        assert (info.maxsize, info.currsize) == (4, 1)
        assert c.extra_stats() == {"evictions": 0, "occupancy": 0.25}
        c.cache_clear()
        info = c.cache_info()
        assert (info.hits, info.misses, info.currsize) == (0, 0, 0)

    def test_registered_in_dispatch_cache_registry(self):
        view = cache_view("batch_cores")
        for key in ("hits", "misses", "maxsize", "currsize", "evictions", "occupancy"):
            assert key in view
        stats = cache_stats(emit=False)
        assert "evictions" in stats["batch_cores"]
        assert "occupancy" in stats["batch_cores"]


# ------------------------------------------------------ health monitor

class TestHealthMonitor:
    def test_state_machine_with_hysteresis(self):
        mon = health.HealthMonitor(window_s=10.0, min_events=5)
        t = 100.0
        for i in range(10):
            mon.observer({"event": "serve_request", "ts_mono": t + i * 0.01})
        with telemetry.capture() as events:
            for i in range(10):
                mon.observer({"event": "serve_shed", "ts_mono": t + 0.2 + i * 0.01})
            snap = mon.evaluate(t + 0.5)
        assert snap["serve"]["state"] == "unhealthy"
        moves = [e for e in events if e["event"] == "health_transition"]
        assert moves and moves[-1]["to"] == "unhealthy"
        # an empty window decays to healthy
        assert mon.evaluate(t + 100.0)["serve"]["state"] == "healthy"
        assert mon.state("never-seen") == "healthy"

    def test_process_monitor_is_installed_by_the_router(self):
        assert health.MONITOR.observer in telemetry._OBSERVERS
