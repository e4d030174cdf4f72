"""The port's data-parallel placement on the CPU: `resolve_mesh` and the
``mesh=`` of every dispatch frontend.

Mirrors the mesh cases of `tests/test_dispatch.py` (`TestResolveMesh`,
`TestShardedBitIdentity`, the mesh cases of `TestCompileDiscipline`) on
its fixture: the custom grid `GridConf(-180, 180, -90, 90, 2, 10, 10)` at
resolution 3 and its three zones, indexed by each package from the same
WKT. The reference runs on its 8 virtual CPU devices; the port runs each
meshed call on a logical CPU mesh of the same shape
(``data_mesh(devices=["cpu"] * n)``: torch has one CPU device, and a
mesh's device list may repeat one). Every meshed answer is held bit for
bit (tolerance 0) against the port's single-device call and against the
reference's meshed call on the same seeded numpy inputs.

`resolve_mesh` with a count or the ``MOSAIC_MESH`` knob takes the
platform's real devices, of which the CPU has one; the knob's cases run
with the platform's device list stood in by eight CPU entries, as the
reference's conftest stands in eight virtual devices.

Also pinned: a dispatch takes each distinct device's lock once, in one
order, so two meshed engines listing the same devices in opposite orders
serve side by side without deadlock.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.raster import Raster as RefRaster
from mosaic_tpu.raster.zonal import ZonalEngine as RefZonalEngine
from mosaic_tpu.serve import BucketLadder as RefLadder
from mosaic_tpu.serve import ServeEngine as RefEngine
from mosaic_tpu.sql import RasterStream as RefRasterStream
from mosaic_tpu.sql import join as RJ
from mosaic_tpu.sql.stream import StreamJoin as RefStreamJoin
from mosaic_tpu.sql.stream import ring_from_host as ref_ring
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.dispatch import core as dispatch
from mosaic_tpu_torch.dispatch.bucket import BucketLadder, backend_compiles, mesh_key
from mosaic_tpu_torch.parallel import mesh as M
from mosaic_tpu_torch.raster import Raster
from mosaic_tpu_torch.raster.zonal import ZonalEngine, host_zonal_zones_oracle
from mosaic_tpu_torch.serve import ServeEngine
from mosaic_tpu_torch.sql import join as TJ
from mosaic_tpu_torch.sql.raster_stream import RasterStream
from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

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
MESHES = (1, 2, 4, 8)
STATS = ("keys", "count", "sum", "min", "max")


def logical(n: int, device: str = "cpu"):
    """The port's stand-in for the reference's ``n`` virtual devices."""
    return dispatch.data_mesh(devices=[device] * n)


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


def _mk_raster(cls, h=75, w=90, seed=5):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 100, (1, h, w))
    data[0][rng.random((h, w)) < 0.1] = -9.0
    return cls(
        data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0), srid=0, nodata=-9.0,
    )


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


# --------------------------------------------------- mesh normalization


class TestResolveMesh:
    @pytest.fixture
    def eight(self, monkeypatch):
        """The platform's devices stood in by eight CPU entries."""
        monkeypatch.setattr(M, "platform_devices", lambda kind: [torch.device(kind)] * 8)

    def test_none_without_knob_is_single_device(self, monkeypatch):
        monkeypatch.delenv("MOSAIC_MESH", raising=False)
        assert dispatch.resolve_mesh(None, device="cpu") is None

    @pytest.mark.parametrize("raw,n", [("2", 2), ("dp4", 4), ("8", 8)])
    def test_env_knob(self, monkeypatch, eight, raw, n):
        monkeypatch.setenv("MOSAIC_MESH", raw)
        m = dispatch.resolve_mesh(None, device="cpu")
        assert m.size == n and m.axis_names == ("dp",) and m.type == "cpu"

    @pytest.mark.parametrize("raw", ["", "0", "1"])
    def test_env_knob_degenerate_is_single_device(self, monkeypatch, raw):
        monkeypatch.setenv("MOSAIC_MESH", raw)
        assert dispatch.resolve_mesh(None, device="cpu") is None

    def test_env_knob_garbage_raises(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_MESH", "lots")
        with pytest.raises(ValueError, match="MOSAIC_MESH"):
            dispatch.resolve_mesh(None, device="cpu")

    def test_int_and_mesh_passthrough(self, eight):
        m = dispatch.resolve_mesh(4, device="cpu")
        assert m.size == 4 and m.axis_names == ("dp",)
        assert dispatch.resolve_mesh(m, device="cpu") is m
        assert dispatch.resolve_mesh(1, device="cpu") is None
        assert mesh_key(m) == (("dp",), (4,), ("cpu",) * 4)

    def test_too_many_devices_raises(self):
        with pytest.raises(ValueError, match="devices"):
            dispatch.data_mesh(99, device="cpu")
        # the CPU platform has one device: a count asks for real ones
        with pytest.raises(ValueError, match="devices"):
            dispatch.resolve_mesh(2, device="cpu")

    def test_logical_mesh_repeats_a_device_and_never_mixes_kinds(self):
        m = logical(4)
        assert m.size == 4 and m.distinct == [torch.device("cpu")]
        with pytest.raises(ValueError, match="mix"):
            M.Mesh(["cpu", "meta"])
        with pytest.raises(ValueError, match="cannot serve"):
            dispatch.resolve_mesh(logical(2, "meta"), device="cpu")


# ------------------------------------------- sharded ≡ single ≡ reference


class TestShardedBitIdentity:
    @pytest.mark.parametrize("mesh", MESHES)
    def test_pip_join(self, index, ref_index, points, mesh):
        # f64 cells: the reference computes them in its f64 input's dtype
        kw = dict(chip_index=index, recheck=False, cell_dtype=torch.float64, device="cpu")
        single = TJ.pip_join(points, None, CUSTOM, RES, **kw)
        oracle = TJ.host_join(points, index.host, CUSTOM, RES)
        np.testing.assert_array_equal(single, oracle)
        sharded = TJ.pip_join(points, None, CUSTOM, RES, mesh=logical(mesh), **kw)
        ref = RJ.pip_join(points, None, REF, RES, chip_index=ref_index,
                          recheck=False, mesh=mesh)
        _same(sharded, single)
        _same(sharded, np.asarray(ref))

    def test_pip_join_mesh_rejects_recheck(self, index, points):
        with pytest.raises(ValueError, match="recheck"):
            TJ.pip_join(points, None, CUSTOM, RES, chip_index=index,
                        recheck=True, mesh=logical(2), device="cpu")

    @pytest.mark.parametrize("mesh", MESHES)
    def test_stream_join(self, index, ref_index, mesh):
        rng = np.random.default_rng(3)
        batches = [rng.uniform((-25, -25), (35, 20), (1024, 2)) for _ in range(2)]
        ring = ring_from_host(batches, device="cpu")
        base = StreamJoin(index, CUSTOM, RES).run(ring, 3, collect=True)
        got = StreamJoin(index, CUSTOM, RES, mesh=logical(mesh)).run(ring, 3, collect=True)
        ref = RefStreamJoin(ref_index, REF, RES, mesh=mesh).run(
            ref_ring(batches), 3, collect=True
        )
        for r in (base, ref):
            assert (got.checksum, got.matches, got.overflow) == (
                r.checksum, r.matches, r.overflow
            )
        _same(got.outs, np.asarray(base.outs))
        _same(got.outs, np.asarray(ref.outs))

    def test_stream_join_batch_must_divide(self, index):
        sj = StreamJoin(index, CUSTOM, RES, mesh=logical(8))
        with pytest.raises(ValueError, match="divide"):
            sj.step(torch.zeros((100, 2), dtype=torch.float64))

    @pytest.mark.parametrize("mesh", MESHES)
    def test_serve_engine(self, index, ref_index, mesh):
        rng = np.random.default_rng(11)
        reqs = [rng.uniform(BBOX[:2], BBOX[2:], (n, 2)) for n in (17, 64, 130, 1000)]
        want = [TJ.host_join(p, index.host, CUSTOM, RES) for p in reqs]
        kw = dict(ladder=BucketLadder(64, 1024), bounds=BBOX, max_wait_s=0.0)
        with ServeEngine(index, CUSTOM, RES, cell_dtype=torch.float64,
                         mesh=logical(mesh), **kw) as eng, ServeEngine(
                index, CUSTOM, RES, cell_dtype=torch.float64, **kw) as one:
            got = [np.asarray(eng.join(p, deadline_s=60.0)) for p in reqs]
            single = [np.asarray(one.join(p, deadline_s=60.0)) for p in reqs]
        with RefEngine(ref_index, REF, RES, ladder=RefLadder(64, 1024), bounds=BBOX,
                       max_wait_s=0.0, mesh=mesh) as reng:
            ref = [np.asarray(reng.join(p, deadline_s=60.0)) for p in reqs]
        for g, s, r, w in zip(got, single, ref, want):
            _same(g, s)
            _same(g, r)
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("mesh", MESHES)
    def test_zonal_zones(self, index, ref_index, mesh):
        r = _mk_raster(Raster)
        base = ZonalEngine(CUSTOM, RES, chip_index=index, device="cpu").zones(r, tile=(32, 32))
        got = ZonalEngine(CUSTOM, RES, chip_index=index, mesh=logical(mesh),
                          device="cpu").zones(r, tile=(32, 32))
        want = host_zonal_zones_oracle(r, index, CUSTOM, RES, tile=(32, 32))
        ref = RefZonalEngine(REF, RES, chip_index=ref_index, mesh=mesh).zones(
            _mk_raster(RefRaster), tile=(32, 32)
        )
        for a in STATS:
            _same(getattr(got, a), getattr(base, a))
            _same(getattr(got, a), np.asarray(getattr(ref, a)))
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))

    def test_zonal_tile_must_divide(self, index):
        eng = ZonalEngine(CUSTOM, RES, chip_index=index, mesh=logical(3), device="cpu")
        with pytest.raises(ValueError, match="divide"):
            eng.zones(_mk_raster(Raster), tile=(32, 32))

    def test_raster_stream_scan(self, index, ref_index):
        r = _mk_raster(Raster)
        base = RasterStream(index, CUSTOM, RES).scan(r, tile=(32, 32))
        got = RasterStream(index, CUSTOM, RES, mesh=logical(4)).scan(r, tile=(32, 32))
        ref = RefRasterStream(ref_index, REF, RES, mesh=4).scan(
            _mk_raster(RefRaster), tile=(32, 32)
        )
        for a in STATS:
            _same(getattr(got.stats, a), getattr(base.stats, a))
            _same(getattr(got.stats, a), np.asarray(getattr(ref.stats, a)))


# ------------------------------------------------- compile discipline


class TestCompileDiscipline:
    def test_warmup_one_signature_per_rung_across_frontends(self, index):
        """After warmup, meshed serve dispatches and meshed batch
        `pip_join` calls add no signature, no cold compile and no nvcc
        build; the signatures carry the mesh."""
        ladder = BucketLadder(64, 512)
        mesh = logical(2)
        with ServeEngine(index, CUSTOM, RES, ladder=ladder, bounds=BBOX,
                         max_wait_s=0.0, mesh=mesh) as eng:
            report = eng.warmup()
            assert report["signatures"] == len(ladder.buckets)
            assert len(eng.core.signatures) == len(ladder.buckets)
            assert {s[-1] for s in eng.core.signatures} == {mesh_key(mesh)}
            t0 = backend_compiles()
            rng = np.random.default_rng(0)
            for n in (5, 64, 65, 200, 512, 30):
                eng.join(rng.uniform(BBOX[:2], BBOX[2:], (n, 2)), deadline_s=60.0)
            TJ.pip_join(rng.uniform(BBOX[:2], BBOX[2:], (300, 2)), None, CUSTOM,
                        RES, chip_index=index, recheck=False, mesh=mesh, device="cpu")
            assert eng.core.cold_compiles == 0
            assert len(eng.core.signatures) == len(ladder.buckets)
            assert backend_compiles() - t0 == 0

    def test_warmup_reports_the_mesh_devices(self, index):
        from mosaic_tpu_torch.runtime import telemetry

        core = dispatch.DispatchCore(index, CUSTOM, RES, ladder=BucketLadder(64, 128),
                                     mesh=logical(4))
        with telemetry.capture() as events:
            core.warmup()
        spans = [e for e in events
                 if e.get("event") == "span" and e.get("name") == "dispatch.warmup"]
        assert len(spans) == 1 and spans[0]["devices"] == 4
        assert core.caps(128) == (32, None, None)

    def test_mesh_must_divide_min_bucket(self, index):
        with pytest.raises(ValueError, match="divide"):
            dispatch.DispatchCore(index, CUSTOM, RES, ladder=BucketLadder(4, 64),
                                  mesh=logical(8))


# ------------------------------------------------------- device locks


class TestDeviceLocks:
    def test_each_distinct_device_once_in_one_order(self):
        order = []
        with dispatch._device_locks(["cpu:1", "cpu:0", "cpu:1"]):
            order = [d for d in ("cpu:0", "cpu:1")
                     if dispatch._device_lock(d).locked()]
        assert order == ["cpu:0", "cpu:1"]
        assert not dispatch._device_lock("cpu:0").locked()

    def test_opposite_orders_take_the_locks_without_deadlock(self):
        """Many threads taking the same two devices' locks listed in
        opposite orders, with a short switch interval so a thread is often
        preempted between two acquisitions: taken in list order, two of
        them would soon hold one lock each and wait for the other."""
        orders = (["cpu:0", "cpu:1"], ["cpu:1", "cpu:0"])
        held = []

        def worker(order):
            for _ in range(2000):
                with dispatch._device_locks(order):
                    held.append(1)
                    held.pop()

        threads = [
            threading.Thread(target=worker, args=(orders[i % 2],), daemon=True)  # lint: thread-context-adoption-ok (test thread: takes locks, records nothing, no fault plan in scope)
            for i in range(2 * (os.cpu_count() or 4))
        ]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            end = time.monotonic() + 60.0
            for t in threads:
                t.join(timeout=max(0.0, end - time.monotonic()))
            assert not any(t.is_alive() for t in threads), "the locks deadlocked"
        finally:
            sys.setswitchinterval(interval)

    def test_opposite_orders_serve_side_by_side(self, index):
        """Two engines whose meshes list the same two devices in opposite
        orders serve concurrently, from more client threads than cores
        with a short switch interval: with each dispatch taking its
        devices' locks in mesh order they could deadlock on each other.
        Every answer stays the single-device one."""
        rng = np.random.default_rng(5)
        reqs = [rng.uniform(BBOX[:2], BBOX[2:], (n, 2)) for n in (40, 64, 100, 128) * 2]
        want = [TJ.pip_join(p, None, CUSTOM, RES, chip_index=index, device="cpu")
                for p in reqs]
        meshes = (dispatch.data_mesh(devices=["cpu:0", "cpu:1"]),
                  dispatch.data_mesh(devices=["cpu:1", "cpu:0"]))
        engines = [ServeEngine(index, CUSTOM, RES, ladder=BucketLadder(64, 128),
                               bounds=BBOX, max_wait_s=0.0, mesh=m) for m in meshes]
        errors = []

        def client(eng):
            try:
                for p, w in zip(reqs, want):
                    np.testing.assert_array_equal(eng.join(p, deadline_s=30.0), w)
            except Exception as e:  # lint: broad-except-ok (the thread reports any failure to the test)
                errors.append(e)

        threads = [
            threading.Thread(target=client, args=(engines[i % 2],))  # lint: thread-context-adoption-ok (test client thread: submits requests, records nothing, no fault plan in scope)
            for i in range(2 * (os.cpu_count() or 4))
        ]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120.0)
            assert not any(t.is_alive() for t in threads), "dispatches deadlocked"
            assert not errors, errors
        finally:
            sys.setswitchinterval(interval)
            for e in engines:
                e.close()
