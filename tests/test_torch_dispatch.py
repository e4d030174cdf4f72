"""The port's dispatch core (`mosaic_tpu_torch/dispatch`) on the CPU.

Mirrors `tests/test_dispatch.py` (its mesh cases, on logical CPU meshes,
are in `tests/test_torch_mesh.py`): the same custom grid
`GridConf(-180, 180, -90, 90, 2, 10, 10)` at resolution 3 and its three
zones, indexed by each package from the same WKT. Contracts:

1. **Signature discipline.** After `warmup()` the signature set equals
   the ladder's rungs and stops growing; a dispatch first seen after
   `freeze()` counts as a cold compile and emits ``dispatch_compile``.
   `backend_compiles()` counts nvcc jobs, the port's only compiler.
2. **One cache surface.** `cache_stats()`/`cache_view()`/`clear_caches()`
   cover every registered cache and emit telemetry; `join_cache_stats`
   serves from the registry; `StreamJoin`s of one spec share one bundle;
   `bounded_cache` refuses an unbounded cache.
3. **Exactness.** A core's rows equal the port's `pip_join` (f32 cells,
   its default) and, with f64 cells, the reference's f64 host oracle
   (tolerance 0).
4. What once raised is carried: ``program_store=`` and
   ``MOSAIC_PROGRAM_STORE`` bind the program store (a second core warms
   from it; its own tests are `tests/test_torch_programs.py`), and a
   meshed core answers the single-device rows, a device count asking for
   real devices (one on the CPU).
"""

import numpy as np
import pytest
import torch

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.sql import join as RJ
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.dispatch import core as dispatch
from mosaic_tpu_torch.dispatch.bucket import BucketLadder, backend_compiles
from mosaic_tpu_torch.kernels import _build
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.sql import join as TJ
from mosaic_tpu_torch.sql.join import join_cache_stats, pip_join
from mosaic_tpu_torch.sql.stream import StreamJoin

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
CUSTOM = CustomIndexSystem(GridConf(*CONF))
REF = RefCustom(RefConf(*CONF))
RES = 3
BBOX = (-25.0, -25.0, 35.0, 20.0)
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1), "
    "(5 5, 5 8, 8 8, 8 5, 5 5))",
    "POLYGON ((20 0, 30 0, 30 10, 25 4, 20 10, 20 0))",
    "MULTIPOLYGON (((-20 -20, -12 -20, -12 -12, -20 -12, -20 -20)), "
    "((-8 -8, -2 -8, -2 -2, -8 -2, -8 -8)))",
]


def port_geometry(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


@pytest.fixture(scope="module")
def col():
    return wkt.from_wkt(ZONES)


@pytest.fixture(scope="module")
def index(col):
    return TJ.build_chip_index(
        tessellate(port_geometry(col), CUSTOM, RES, keep_core_geoms=False),
        device="cpu",
    )


@pytest.fixture(scope="module")
def ref_index(col):
    return RJ.build_chip_index(ref_tessellate(col, REF, RES, keep_core_geoms=False))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(7)
    return rng.uniform(BBOX[:2], BBOX[2:], (1024, 2))


# ------------------------------------------------------------ the ladder


class TestLadder:
    def test_rungs_and_bucket_for(self):
        lad = BucketLadder(64, 1024)
        assert lad.buckets == (64, 128, 256, 512, 1024)
        assert [lad.bucket_for(n) for n in (1, 64, 65, 1000, 1024)] == [
            64, 64, 128, 1024, 1024,
        ]
        with pytest.raises(ValueError, match="exceeds the top bucket"):
            lad.bucket_for(1025)

    def test_pad_repeats_first_row_and_keeps_full_buckets(self):
        pts = np.array([[1.0, 2.0], [3.0, 4.0]])
        padded, n = BucketLadder(4, 16).pad(pts)
        assert n == 2 and padded.shape == (4, 2) and padded.dtype == np.float64
        np.testing.assert_array_equal(padded[2:], [[1.0, 2.0], [1.0, 2.0]])
        full = np.zeros((4, 2))
        assert BucketLadder(4, 16).pad(full)[0] is full

    @pytest.mark.parametrize("bad", [dict(min_bucket=0), dict(min_bucket=8, max_bucket=4),
                                     dict(growth=1)])
    def test_invalid_ladders_raise(self, bad):
        with pytest.raises(ValueError):
            BucketLadder(**bad)


# ------------------------------------------------- signature discipline


class TestCompileDiscipline:
    def test_warmup_one_signature_per_rung_then_none(self, index):
        """After warmup, random sizes across the ladder add no signature,
        no cold compile and no nvcc build."""
        ladder = BucketLadder(64, 512)
        core = dispatch.DispatchCore(index, CUSTOM, RES, ladder=ladder)
        report = core.warmup()
        assert report["signatures"] == len(ladder.buckets) == len(core.signatures)
        assert report["backend_compiles"] == 0
        c0 = backend_compiles()
        rng = np.random.default_rng(0)
        for n in (5, 64, 65, 200, 512, 30):
            pts = rng.uniform(BBOX[:2], BBOX[2:], (n, 2))
            np.testing.assert_array_equal(
                core.execute(pts),
                pip_join(pts, None, CUSTOM, RES, chip_index=index,
                         recheck=False, device="cpu"),
            )
        assert core.cold_compiles == 0
        assert len(core.signatures) == len(ladder.buckets)
        assert backend_compiles() - c0 == 0

    def test_warmup_emits_spans_and_stage_timings(self, index):
        core = dispatch.DispatchCore(index, CUSTOM, RES, ladder=BucketLadder(64, 128))
        with telemetry.capture() as events:
            report = core.warmup()
        assert report["buckets"] == 2 and core.warmed
        stages = [
            e for e in events
            if e.get("event") == "dispatch_stage" and e.get("stage") == "warmup"
        ]
        assert [e["bucket"] for e in stages] == [64, 128]
        assert all(e["seconds"] >= 0 for e in stages)
        assert any(e.get("event") == "dispatch_warmup" for e in events)
        spans = [
            e for e in events
            if e.get("event") == "span" and e.get("name") == "dispatch.warmup"
        ]
        assert len(spans) == 1

    def test_post_freeze_compile_emits_event(self, index):
        core = dispatch.DispatchCore(index, CUSTOM, RES, ladder=BucketLadder(64, 128))
        core.freeze()  # arm the tripwire without warming
        with telemetry.capture() as events:
            core.execute(np.zeros((10, 2)))
        assert core.cold_compiles == 1
        assert any(e.get("event") == "dispatch_compile" for e in events)
        spans = [e for e in events if e.get("name") == "dispatch.compile"]
        assert len(spans) == 1 and spans[0]["backend_compiles"] == 0

    def test_core_runs_on_the_index_device_with_full_bucket_caps(self, index):
        core = dispatch.DispatchCore(index, CUSTOM, RES, probe="adaptive")
        assert core.device.type == "cpu" and core.lookup == "gather"
        fcap, hcap, ccap = core.caps(256)
        assert fcap == 256
        assert hcap == (256 if index.num_heavy_cells else None)
        assert ccap == (256 if index.num_convex_cells else None)
        assert core.load_kernels() == []  # no kernel launches on the CPU

    def test_adaptive_direct_rejected(self, index):
        with pytest.raises(ValueError, match="adaptive"):
            dispatch.DispatchCore(index, CUSTOM, RES, probe="adaptive",
                                  writeback="direct")


class TestBackendCompiles:
    def test_counts_one_nvcc_job_per_missing_library(self, tmp_path, monkeypatch):
        """`backend_compiles()` reads the nvcc jobs this process started:
        one per library missing on disk, none once it is built."""
        src = tmp_path / "k.cu"
        src.write_text("// kernel source\n")
        monkeypatch.setattr(_build, "SOURCES", {"k": src})
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")

        class FakeNvcc:
            returncode = 0

            def __init__(self, cmd, **kw):
                self.out = cmd[cmd.index("-o") + 1]

            def communicate(self):
                with open(self.out, "w") as fh:
                    fh.write("built")
                return "", ""

        monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
        c0 = backend_compiles()
        _build.compile_libraries(["k"])
        assert backend_compiles() - c0 == 1
        _build.compile_libraries(["k"])  # on disk now: no job
        assert backend_compiles() - c0 == 1


# ---------------------------------------------------------- exactness


class TestExactness:
    @pytest.mark.parametrize("probe", ["scatter", "adaptive"])
    def test_default_f32_cells_equal_pip_join(self, index, points, probe):
        core = dispatch.DispatchCore(index, CUSTOM, RES, probe=probe,
                                     ladder=BucketLadder(64, 1024))
        np.testing.assert_array_equal(
            core.execute(points),
            pip_join(points, None, CUSTOM, RES, chip_index=index,
                     recheck=False, device="cpu"),
        )

    def test_f64_cells_equal_reference_host_oracle(self, index, ref_index, points):
        core = dispatch.DispatchCore(index, CUSTOM, RES, cell_dtype=torch.float64,
                                     ladder=BucketLadder(64, 1024))
        np.testing.assert_array_equal(
            core.execute(points), RJ.host_join(points, ref_index.host, REF, RES)
        )

    def test_cpu_exhaustion_degrades_to_host_join(self, index, points):
        from mosaic_tpu_torch.runtime import DegradedResult, faults

        core = dispatch.DispatchCore(index, CUSTOM, RES, ladder=BucketLadder(64, 1024))
        padded, n = core.ladder.pad(points[:100])
        with faults.transient_errors(10, sites=("serve.dispatch",)):
            out = core.execute_resilient("serve.dispatch", padded)
        assert isinstance(out, DegradedResult)
        np.testing.assert_array_equal(
            np.asarray(out), TJ.host_join(padded, index.host, CUSTOM, RES)
        )


# ---------------------------------------------------- the cache registry


class TestCacheRegistry:
    def test_cache_stats_covers_every_registered_cache(self, index):
        pip_join(np.zeros((8, 2)), None, CUSTOM, RES, chip_index=index,
                 recheck=False, device="cpu")
        with telemetry.capture() as events:
            stats = dispatch.cache_stats()
        assert any(e.get("event") == "dispatch_cache_stats" for e in events)
        for name in ("cells_prog", "stream_programs"):
            assert set(stats[name]) == {"hits", "misses", "maxsize", "currsize"}, name
        assert set(stats["batch_cores"]) == {
            "hits", "misses", "maxsize", "currsize", "evictions", "occupancy",
        }
        # the port's stand-in for the reference's jit_programs
        assert set(stats["kernels"]) == {"libraries", "backend_compiles"}
        assert "jit_programs" not in stats

    def test_pip_join_cells_go_through_the_registry(self, index):
        before = dispatch.cache_view("cells_prog")
        for _ in range(2):
            pip_join(np.zeros((8, 2)), None, CUSTOM, RES, chip_index=index,
                     recheck=False, device="cpu")
        after = dispatch.cache_view("cells_prog")
        assert after["hits"] + after["misses"] - before["hits"] - before["misses"] == 2
        assert after["hits"] > before["hits"]

    def test_clear_caches_is_selective_and_emits(self, index):
        StreamJoin(index, CUSTOM, RES)  # populate stream_programs
        pip_join(np.zeros((8, 2)), None, CUSTOM, RES, chip_index=index,
                 recheck=False, device="cpu")
        assert dispatch.cache_view("stream_programs")["currsize"] > 0
        before = dispatch.cache_view("cells_prog")["currsize"]
        assert before > 0
        with telemetry.capture() as events:
            pre = dispatch.clear_caches(names=("stream_programs",))
        assert any(e.get("event") == "dispatch_caches_cleared" for e in events)
        assert pre["stream_programs"]["currsize"] > 0  # the pre-clear view
        assert dispatch.cache_view("stream_programs")["currsize"] == 0
        assert dispatch.cache_view("cells_prog")["currsize"] == before

    def test_unbounded_cache_rejected(self):
        with pytest.raises(ValueError, match="bounded"):
            dispatch.bounded_cache("nope", None)
        import functools

        with pytest.raises(ValueError, match="bounded"):
            dispatch.register_cache("nope", functools.lru_cache(maxsize=None)(len))

    def test_join_view_serves_from_registry(self, index):
        legacy = join_cache_stats(emit=False)
        assert legacy["cells_prog"] == dispatch.cache_view("cells_prog")
        assert legacy["kernels"]["backend_compiles"] == backend_compiles()

    def test_stream_program_bundle_is_shared(self, index):
        a = StreamJoin(index, CUSTOM, RES, prefetch=True)
        b = StreamJoin(index, CUSTOM, RES, prefetch=True)
        assert a._loop is b._loop  # one bundle, not one per join
        c = StreamJoin(index, CUSTOM, RES, prefetch=False)
        assert c._loop is not a._loop

    def test_core_for_reuses_one_core(self, index):
        a = dispatch.core_for(index, CUSTOM, RES, ladder=BucketLadder(64, 128))
        b = dispatch.core_for(index, CUSTOM, RES, ladder=BucketLadder(64, 128))
        c = dispatch.core_for(index, CUSTOM, RES, ladder=BucketLadder(64, 256))
        assert a is b and c is not a
        view = dispatch.cache_view("batch_cores")
        assert view["hits"] >= 1 and view["currsize"] >= 2


# ----------------------------------------------------- what is refused


class TestNotPorted:
    def test_mesh_names_item_12(self, index, points):
        """``mesh=`` is ported (it raised before): a device count takes
        real devices, and the CPU has one; a logical 2-device mesh core
        answers the single-device rows and ``core_for`` keys on it."""
        with pytest.raises(ValueError, match="devices"):
            dispatch.DispatchCore(index, CUSTOM, RES, mesh=2)
        with pytest.raises(ValueError, match="devices"):
            dispatch.core_for(index, CUSTOM, RES, mesh=2)
        mesh = dispatch.data_mesh(devices=["cpu"] * 2)
        ladder = BucketLadder(64, 1024)
        meshed = dispatch.DispatchCore(index, CUSTOM, RES, ladder=ladder, mesh=mesh)
        single = dispatch.DispatchCore(index, CUSTOM, RES, ladder=ladder)
        assert meshed.mesh is mesh and meshed.caps(1024)[0] == 512
        np.testing.assert_array_equal(meshed.execute(points), single.execute(points))
        a = dispatch.core_for(index, CUSTOM, RES, ladder=ladder, mesh=mesh)
        assert a.mesh is mesh and a is not dispatch.core_for(index, CUSTOM, RES, ladder=ladder)

    def test_program_store_names_queue_3(self, index, tmp_path, points):
        """``program_store=`` is ported (it raised naming queue 3 before):
        the first core exports its rungs, a second one warms from them and
        answers the same rows."""
        ladder = BucketLadder(64, 1024)
        first = dispatch.DispatchCore(index, CUSTOM, RES, ladder=ladder,
                                      program_store=str(tmp_path))
        assert first.warmup()["aot"] == {"loaded": 0, "exported": 10, "fallback": 0}
        second = dispatch.DispatchCore(index, CUSTOM, RES, ladder=ladder,
                                       program_store=str(tmp_path))
        assert second.warmup()["aot"] == {"loaded": 10, "exported": 0, "fallback": 0}
        np.testing.assert_array_equal(second.execute(points), first.execute(points))

    def test_program_store_env_names_queue_3(self, index, tmp_path, monkeypatch):
        """``MOSAIC_PROGRAM_STORE`` binds the same store (it raised before)."""
        monkeypatch.setenv("MOSAIC_PROGRAM_STORE", str(tmp_path))
        ladder = BucketLadder(64, 1024)
        dispatch.DispatchCore(index, CUSTOM, RES, ladder=ladder).warmup()
        core = dispatch.DispatchCore(index, CUSTOM, RES, ladder=ladder)
        assert core._programs.root == str(tmp_path)
        assert core.warmup()["aot"] == {"loaded": 10, "exported": 0, "fallback": 0}


class TestDeviceLock:
    def test_one_dispatch_at_a_time_on_a_device(self, index, points):
        """While the device's lock is held, a dispatch on another thread
        waits for it, then answers as it would have."""
        import threading

        core = dispatch.DispatchCore(index, CUSTOM, RES, ladder=BucketLadder(64, 1024))
        padded, n = core.ladder.pad(points[:100])
        want = core.execute_padded(padded)
        got = []
        th = threading.Thread(target=lambda: got.append(core.execute_padded(padded)))  # lint: thread-context-adoption-ok (lock-order probe; no telemetry or fault context)
        with dispatch._device_lock(core.device):
            th.start()
            th.join(timeout=0.2)
            assert th.is_alive() and not got  # waiting for the lock
        th.join(timeout=30)
        np.testing.assert_array_equal(got[0], want)
        assert dispatch._device_lock(core.device) is dispatch._device_lock(index.device)
