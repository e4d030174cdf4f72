"""The port's self-tuning workload optimizer (`mosaic_tpu_torch/tune/`)
against the reference's (`mosaic_tpu/tune/`), class for class with
`tests/test_tune.py`, on the CPU and its fixture (the custom grid
`GridConf(-180, 180, -90, 90, 2, 10, 10)` at resolution 3, three zones,
2,048 points of seed 11).

Every test runs both packages on the same seeded numpy inputs and holds
the port to the reference exactly: the resolver's values and sources,
each frontend's ``tune_resolve`` event (the volatile stamps aside), the
profiles' statistics bit for bit, recommendations with their rationales,
and join answers bit for bit. Besides the reference's contracts:

- profile stores are interchangeable: each package loads the other's;
- the router's ``add_tenant(profile_root=)`` with a good, a corrupt and a
  mismatched store;
- ``EpochalIndex.publish(reprofile=True)`` and
  ``ServeRouter.advance_epoch(reprofile=True)`` serve exact answers at
  the epochal index's resolution while the profile's other knobs apply
  (the reference's engine takes the profile's resolution instead:
  ROADMAP queue 3);
- ``load_priors()`` reads only ``mosaic_tpu_torch/tune/priors/``, and
  every artifact there is a measurement on an NVIDIA card.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from mosaic_tpu import tune as RT
from mosaic_tpu.core.geometry import wkt
from mosaic_tpu.core.index import CustomIndexSystem as RefCustom
from mosaic_tpu.core.index import GridConf as RefConf
from mosaic_tpu.core.tessellate import tessellate as ref_tessellate
from mosaic_tpu.raster import Raster as RefRaster
from mosaic_tpu.raster.zonal import ZonalEngine as RefZonalEngine
from mosaic_tpu.runtime import telemetry as ref_telemetry
from mosaic_tpu.serve import BucketLadder as RefLadder
from mosaic_tpu.serve import ServeEngine as RefServeEngine
from mosaic_tpu.sql import join as RJ
from mosaic_tpu.sql.overlay import candidate_pairs as ref_candidate_pairs
from mosaic_tpu.sql.raster_stream import RasterStream as RefRasterStream
from mosaic_tpu.sql.stream import StreamJoin as RefStreamJoin
from mosaic_tpu.sql.stream import ring_from_host as ref_ring_from_host
from mosaic_tpu_torch import tune as T
from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
from mosaic_tpu_torch.core.tessellate import tessellate
from mosaic_tpu_torch.core.types import PackedGeometry
from mosaic_tpu_torch.index import EpochalIndex
from mosaic_tpu_torch.raster import Raster
from mosaic_tpu_torch.raster.zonal import ZonalEngine
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.serve import BucketLadder, ServeEngine, ServeRouter
from mosaic_tpu_torch.sql import join as TJ
from mosaic_tpu_torch.sql.overlay import candidate_pairs
from mosaic_tpu_torch.sql.raster_stream import RasterStream
from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

CONF = (-180, 180, -90, 90, 2, 10.0, 10.0)
CUSTOM = CustomIndexSystem(GridConf(*CONF))
REF_CUSTOM = RefCustom(RefConf(*CONF))
RES = 3
ZONES = [
    "POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1), "
    "(5 5, 5 8, 8 8, 8 5, 5 5))",
    "POLYGON ((20 0, 30 0, 30 10, 25 4, 20 10, 20 0))",
    "POLYGON ((-20 -20, -5 -20, -5 -5, -20 -5, -20 -20))",
]
BBOX = (-25.0, -25.0, 35.0, 20.0)

ALL_TUNE_ENV = (
    "MOSAIC_TUNE_PROBE", "MOSAIC_TUNE_WRITEBACK", "MOSAIC_TUNE_LOOKUP",
    "MOSAIC_TUNE_BATCH", "MOSAIC_TUNE_BUCKET_MIN", "MOSAIC_TUNE_BUCKET_MAX",
    "MOSAIC_TUNE_KNN_LANE", "MOSAIC_STREAM_WINDOW", "MOSAIC_STREAM_PIPELINE",
    "MOSAIC_RASTER_TILE", "MOSAIC_RASTER_LANE", "MOSAIC_EPOCH_LOG_MAX",
    "MOSAIC_PROBE_FORCE_LANE",
)

#: event fields that stamp a run, not a resolution
VOLATILE = {"seq", "ts_mono", "trace_id", "span_id", "seconds"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ALL_TUNE_ENV:
        monkeypatch.delenv(name, raising=False)
    yield


def port_col(col) -> PackedGeometry:
    return PackedGeometry(
        xy=np.asarray(col.xy), ring_offsets=np.asarray(col.ring_offsets),
        part_offsets=np.asarray(col.part_offsets),
        geom_offsets=np.asarray(col.geom_offsets),
        geom_type=np.asarray(col.geom_type), srid=np.asarray(col.srid),
    )


@pytest.fixture(scope="module")
def ref_zones():
    return wkt.from_wkt(ZONES)


@pytest.fixture(scope="module")
def zones(ref_zones):
    return port_col(ref_zones)


@pytest.fixture(scope="module")
def ref_index(ref_zones):
    return RJ.build_chip_index(
        ref_tessellate(ref_zones, REF_CUSTOM, RES, keep_core_geoms=False)
    )


@pytest.fixture(scope="module")
def index(zones):
    return TJ.build_chip_index(
        tessellate(zones, CUSTOM, RES, keep_core_geoms=False), device="cpu"
    )


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    return rng.uniform(BBOX[:2], BBOX[2:], (2048, 2))


def _mk_raster(cls, h=64, w=64, nodata=-9.0, seed=5):
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, 100, (1, h, w))
    data[0][rng.random((h, w)) < 0.5] = nodata
    return cls(
        data=data, gt=(-0.5, 1.0, 0.0, 15.5, 0.0, -1.0),
        srid=0, nodata=nodata,
    )


def resolve_events(events, entry):
    return [
        {k: v for k, v in e.items() if k not in VOLATILE}
        for e in events
        if e.get("event") == "tune_resolve" and e.get("entry") == entry
    ]


def both_events(ref_call, port_call, entry):
    """The one ``tune_resolve`` event of ``entry`` each package records
    for the same call; asserts they are equal and returns the port's."""
    with ref_telemetry.capture() as rev:
        ref_out = ref_call()
    with telemetry.capture() as pev:
        port_out = port_call()
    (r,) = resolve_events(rev, entry)
    (p,) = resolve_events(pev, entry)
    assert p == r
    return p, ref_out, port_out


def rprof(**kw):
    return RT.TuningProfile(**kw)


def pprof(**kw):
    return T.TuningProfile(**kw)


# --------------------------------------------------------------- resolver


class TestResolveKnob:
    """Each of the reference's resolver contracts, in both packages."""

    def both(self, *args):
        r = RT.resolve_knob(args[0], args[1], _ref_profile(args[2]), args[3])
        p = T.resolve_knob(*args)
        assert p == r
        return p

    def test_explicit_beats_everything(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "adaptive")
        assert self.both("probe", "scatter", pprof(probe="mxu"), "x") == (
            "scatter", "explicit"
        )

    def test_env_beats_profile(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "adaptive")
        assert self.both("probe", None, pprof(probe="scatter"), "x") == (
            "adaptive", "env"
        )

    def test_profile_beats_default(self):
        assert self.both("probe", None, pprof(probe="adaptive"), "scatter") == (
            "adaptive", "profile"
        )

    def test_default_when_nothing_set(self):
        assert self.both("probe", None, None, "scatter") == (
            "scatter", "default"
        )

    def test_empty_env_is_unset(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "")
        assert self.both("probe", None, None, "d") == ("d", "default")

    def test_env_parsers(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_BATCH", "4096")
        assert self.both("batch_size", None, None, None) == (4096, "env")
        monkeypatch.setenv("MOSAIC_RASTER_TILE", "64x128")
        assert self.both("raster_tile", None, None, None) == ((64, 128), "env")
        # "0" must WIN with value False (force-off), not fall through
        monkeypatch.setenv("MOSAIC_STREAM_PIPELINE", "0")
        prof = pprof(stream_pipeline=True)
        assert self.both("stream_pipeline", None, prof, None) == (False, "env")

    @pytest.mark.parametrize("knob,var,raw", [
        ("batch_size", "MOSAIC_TUNE_BATCH", "many"),
        ("bucket_min", "MOSAIC_TUNE_BUCKET_MIN", "x"),
        ("raster_tile", "MOSAIC_RASTER_TILE", "0x4"),
        ("stream_window", "MOSAIC_STREAM_WINDOW", "many"),
    ])
    def test_malformed_env_raises(self, monkeypatch, knob, var, raw):
        monkeypatch.setenv(var, raw)
        for mod in (RT, T):
            with pytest.raises(ValueError, match="malformed env value"):
                mod.resolve_knob(knob, None, None, None)

    def test_resolution_has_no_env_layer(self, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_RESOLUTION", "9")
        assert self.both("resolution", None, pprof(resolution=4), 3) == (
            4, "profile"
        )

    def test_unknown_knob_rejected(self):
        for mod in (RT, T):
            with pytest.raises(KeyError, match="unknown tune knob"):
                mod.resolve_knob("warp_factor", None, None, None)

    def test_every_knob_resolves_through_all_layers(self, monkeypatch):
        """The full matrix at the resolver: each knob accepts each layer,
        in both packages; the port's knob set is the reference's plus its
        own ``epoch_log_max``, which no profile carries."""
        profile_values = {
            "resolution": 5, "probe": "adaptive", "writeback": "sort",
            "lookup": "gather", "batch_size": 2048, "bucket_min": 128,
            "bucket_max": 1024, "stream_window": 6, "stream_pipeline": True,
            "raster_tile": (64, 64), "zonal_lane": "tiled",
            "knn_lane": "voronoi",
        }
        env_values = {
            "probe": ("MOSAIC_TUNE_PROBE", "scatter", "scatter"),
            "writeback": ("MOSAIC_TUNE_WRITEBACK", "scatter", "scatter"),
            "lookup": ("MOSAIC_TUNE_LOOKUP", "mxu", "mxu"),
            "batch_size": ("MOSAIC_TUNE_BATCH", "512", 512),
            "bucket_min": ("MOSAIC_TUNE_BUCKET_MIN", "64", 64),
            "bucket_max": ("MOSAIC_TUNE_BUCKET_MAX", "256", 256),
            "stream_window": ("MOSAIC_STREAM_WINDOW", "2", 2),
            "stream_pipeline": ("MOSAIC_STREAM_PIPELINE", "1", True),
            "raster_tile": ("MOSAIC_RASTER_TILE", "32x32", (32, 32)),
            "zonal_lane": ("MOSAIC_RASTER_LANE", "fold", "fold"),
            "knn_lane": ("MOSAIC_TUNE_KNN_LANE", "ring", "ring"),
        }
        assert set(RT.KNOBS) == set(profile_values)
        assert set(T.KNOBS) == set(RT.KNOBS) | {"epoch_log_max"}
        prof = pprof(**profile_values)
        for knob in RT.KNOBS:
            assert self.both(knob, None, prof, "dflt") == (
                profile_values[knob], "profile"
            ), knob
            assert self.both(knob, None, None, "dflt") == ("dflt", "default")
            if knob in env_values:
                var, raw, parsed = env_values[knob]
                monkeypatch.setenv(var, raw)
                assert self.both(knob, None, prof, "dflt") == (parsed, "env")
                monkeypatch.delenv(var)
            assert self.both(knob, "xx", prof, "dflt") == ("xx", "explicit")
        assert T.resolve_knob("epoch_log_max", None, prof, 0) == (0, "default")

    def test_knn_lane_env_is_checked(self, monkeypatch):
        """The port refuses a malformed ``MOSAIC_TUNE_KNN_LANE`` in the
        resolver; the reference lets it through to the frontend."""
        monkeypatch.setenv("MOSAIC_TUNE_KNN_LANE", "grid")
        assert RT.resolve_knob("knn_lane", None, None, None) == ("grid", "env")
        with pytest.raises(ValueError, match="malformed env value"):
            T.resolve_knob("knn_lane", None, None, None)


def _ref_profile(p):
    """The reference's TuningProfile with a port profile's knobs."""
    if p is None or isinstance(p, RT.TuningProfile):
        return p
    return RT.TuningProfile.from_dict(p.as_dict())


# ------------------------------------------------- frontend entry points


class TestPipJoinPrecedence:
    KW = dict(resolution=RES, probe="adaptive", writeback="scatter",
              lookup="gather", batch_size=1024)

    def run(self, points, ref_index, index, profile=None, **kw):
        res = kw.pop("resolution", None)
        ev, want, got = both_events(
            lambda: np.asarray(RJ.pip_join(
                points, None, REF_CUSTOM, res, chip_index=ref_index,
                profile=_ref_profile(profile), **kw)),
            lambda: TJ.pip_join(
                points, None, CUSTOM, res, chip_index=index,
                profile=profile, device="cpu", **kw),
            "pip_join",
        )
        np.testing.assert_array_equal(got, want)
        return got, ev

    def test_profile_layer(self, points, ref_index, index):
        out, ev = self.run(points, ref_index, index, profile=pprof(**self.KW))
        for knob in ("resolution", "probe", "writeback", "lookup",
                     "batch_size"):
            assert ev[f"{knob}_source"] == "profile", (knob, ev)
        assert ev["probe"] == "adaptive" and ev["batch_size"] == 1024
        base, _ = self.run(points, ref_index, index, resolution=RES)
        np.testing.assert_array_equal(out, base)

    def test_env_layer_beats_profile(self, points, ref_index, index, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "scatter")
        monkeypatch.setenv("MOSAIC_TUNE_BATCH", "512")
        _, ev = self.run(points, ref_index, index, profile=pprof(**self.KW))
        assert ev["probe_source"] == "env" and ev["probe"] == "scatter"
        assert ev["batch_size_source"] == "env" and ev["batch_size"] == 512
        assert ev["resolution_source"] == "profile"

    def test_explicit_beats_env_and_profile(self, points, ref_index, index,
                                            monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "adaptive")
        _, ev = self.run(
            points, ref_index, index, resolution=RES, probe="scatter",
            writeback="scatter", lookup="gather", batch_size=256,
            profile=pprof(**self.KW),
        )
        for knob in ("resolution", "probe", "writeback", "lookup",
                     "batch_size"):
            assert ev[f"{knob}_source"] == "explicit", (knob, ev)

    def test_lookup_default_is_recorded_as_the_reference_does(
        self, points, ref_index, index
    ):
        """No lookup anywhere: both events record ``lookup=None`` from
        the default layer (each package then runs the gather lane)."""
        _, ev = self.run(points, ref_index, index, resolution=RES)
        assert ev["lookup"] is None and ev["lookup_source"] == "default"
        assert ev["profiled"] is False

    def test_no_resolution_anywhere_is_typed(self, points, ref_index, index):
        with pytest.raises(ValueError, match="resolution"):
            RJ.pip_join(points, None, REF_CUSTOM, None, chip_index=ref_index)
        with pytest.raises(ValueError, match="or via a profile"):
            TJ.pip_join(points, None, CUSTOM, None, chip_index=index,
                        device="cpu")

    def test_zero_batch_size_forces_the_unbatched_path(self, points, index):
        with telemetry.capture() as ev:
            out = TJ.pip_join(points, None, CUSTOM, None, chip_index=index,
                              batch_size=0, profile=pprof(**self.KW),
                              device="cpu")
        (e,) = resolve_events(ev, "pip_join")
        assert e["batch_size"] == 0 and e["batch_size_source"] == "explicit"
        want = TJ.pip_join(points, None, CUSTOM, RES, chip_index=index,
                           device="cpu")
        np.testing.assert_array_equal(out, want)


class TestStreamJoinPrecedence:
    def test_constructor_knobs(self, ref_index, index, monkeypatch):
        prof = pprof(probe="adaptive", lookup="gather")

        def mk(**kw):
            return both_events(
                lambda: RefStreamJoin(ref_index, REF_CUSTOM, RES,
                                      profile=_ref_profile(prof), **kw),
                lambda: StreamJoin(index, CUSTOM, RES, profile=prof, **kw),
                "stream_join",
            )

        ev, _, sj = mk()
        assert ev["probe_source"] == "profile"
        assert ev["lookup_source"] == "profile"
        assert sj.probe == "adaptive"

        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "scatter")
        ev, _, sj = mk()
        assert ev["probe_source"] == "env" and ev["probe"] == "scatter"
        assert sj.probe == "scatter"

        ev, _, _ = mk(probe="scatter")
        assert ev["probe_source"] == "explicit"

    def test_durable_run_knobs(self, ref_index, index, tmp_path, monkeypatch):
        """stream_window / stream_pipeline resolve per durable run, and
        the runs' statistics equal the reference's."""
        rng = np.random.default_rng(3)
        batches = [rng.uniform(BBOX[:2], BBOX[2:], (512, 2)) for _ in range(2)]
        rring = ref_ring_from_host(batches)
        ring = ring_from_host(batches, device="cpu")
        prof = pprof(stream_window=2, stream_pipeline=True)
        rsj = RefStreamJoin(ref_index, REF_CUSTOM, RES,
                            profile=_ref_profile(prof))
        sj = StreamJoin(index, CUSTOM, RES, profile=prof)

        def run(name, **kw):
            ev, want, got = both_events(
                lambda: rsj.run_durable(rring, 2, run_dir=str(tmp_path / f"r{name}"), **kw),
                lambda: sj.run_durable(ring, 2, run_dir=str(tmp_path / f"p{name}"), **kw),
                "stream_join.run_durable",
            )
            assert (got.checksum, got.matches, got.overflow, got.n_points) == (
                int(want.checksum), int(want.matches), int(want.overflow),
                int(want.n_points))
            return ev

        ev = run("a")
        assert ev["stream_pipeline_source"] == "profile"
        assert ev["stream_window_source"] == "profile"
        assert ev["stream_pipeline"] is True and ev["stream_window"] == 2

        monkeypatch.setenv("MOSAIC_STREAM_PIPELINE", "0")
        monkeypatch.setenv("MOSAIC_STREAM_WINDOW", "3")
        ev = run("b")
        assert ev["stream_pipeline_source"] == "env"
        assert ev["stream_pipeline"] is False  # "0" forces OFF over profile
        assert ev["stream_window_source"] == "env" and ev["stream_window"] == 3

        ev = run("c", pipeline=True, window=4)
        assert ev["stream_pipeline_source"] == "explicit"
        assert ev["stream_window_source"] == "explicit"
        assert ev["stream_window"] == 4


class TestServeEnginePrecedence:
    def mk(self, ref_index, index, profile, **kw):
        rkw = dict(kw)
        if "ladder" in rkw:
            rkw["ladder"] = RefLadder(*rkw["ladder"])
        if "ladder" in kw:
            kw["ladder"] = BucketLadder(*kw["ladder"])
        ref_ladder = []

        def ref_call():
            with RefServeEngine(ref_index, REF_CUSTOM, RES,
                                profile=_ref_profile(profile), **rkw) as eng:
                ref_ladder.append(eng.ladder.buckets)

        def port_call():
            with ServeEngine(index, CUSTOM, RES, profile=profile, **kw) as eng:
                return eng.ladder.buckets, eng.probe, eng.writeback

        ev, _, got = both_events(ref_call, port_call, "serve_engine")
        assert got[0] == ref_ladder[0]
        return ev, got

    def test_profile_builds_ladder(self, ref_index, index):
        prof = pprof(probe="adaptive", writeback="scatter", lookup="gather",
                     bucket_min=64, bucket_max=256)
        ev, (buckets, probe, writeback) = self.mk(ref_index, index, prof)
        assert buckets == (64, 128, 256) and probe == "adaptive"
        for knob in ("probe", "writeback", "lookup", "bucket_min",
                     "bucket_max"):
            assert ev[f"{knob}_source"] == "profile", (knob, ev)

    def test_env_beats_profile(self, ref_index, index, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_BUCKET_MIN", "128")
        monkeypatch.setenv("MOSAIC_TUNE_BUCKET_MAX", "512")
        monkeypatch.setenv("MOSAIC_TUNE_WRITEBACK", "scatter")
        prof = pprof(bucket_min=64, bucket_max=256, writeback="sort")
        ev, (buckets, _, writeback) = self.mk(ref_index, index, prof)
        assert buckets == (128, 256, 512) and writeback == "scatter"
        assert ev["bucket_min_source"] == "env"
        assert ev["bucket_max_source"] == "env"
        assert ev["writeback_source"] == "env"

    def test_explicit_ladder_bypasses_bucket_knobs(self, ref_index, index,
                                                   monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_BUCKET_MIN", "128")
        prof = pprof(bucket_min=64, bucket_max=256)
        _, (buckets, _, _) = self.mk(ref_index, index, prof, ladder=(32, 64))
        assert buckets == (32, 64)

    def test_explicit_probe_beats_all(self, ref_index, index, monkeypatch):
        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "adaptive")
        ev, (_, probe, _) = self.mk(ref_index, index, pprof(probe="adaptive"),
                                    probe="scatter")
        assert ev["probe_source"] == "explicit" and probe == "scatter"

    def test_one_bucket_end_keeps_the_other_default(self, ref_index, index):
        _, (buckets, _, _) = self.mk(ref_index, index, pprof(bucket_max=256))
        assert buckets == (64, 128, 256)

    def test_profiled_engine_answers_equal_pip_join(self, index, points):
        prof = pprof(probe="adaptive", bucket_min=64, bucket_max=512)
        with ServeEngine(index, CUSTOM, RES, profile=prof, bounds=BBOX,
                         max_wait_s=0.001) as eng:
            eng.warmup()
            got = np.asarray(eng.join(points[:500], timeout=30.0))
            assert eng.metrics()["cold_compiles"] == 0
        want = TJ.pip_join(points[:500], None, CUSTOM, RES, chip_index=index,
                           recheck=False, device="cpu")
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


class TestZonalEnginePrecedence:
    def mk(self, ref_index, index, prof, **kw):
        return both_events(
            lambda: RefZonalEngine(REF_CUSTOM, RES, chip_index=ref_index,
                                   profile=_ref_profile(prof), **kw),
            lambda: ZonalEngine(CUSTOM, RES, chip_index=index, profile=prof,
                                device="cpu", **kw),
            "zonal_engine",
        )

    def test_all_layers(self, ref_index, index, monkeypatch):
        prof = pprof(probe="adaptive", lookup="gather", zonal_lane="tiled")
        ev, reng, eng = self.mk(ref_index, index, prof)
        for knob in ("probe", "lookup", "zonal_lane"):
            assert ev[f"{knob}_source"] == "profile", (knob, ev)
        assert eng.lane == reng.lane == "tiled"

        monkeypatch.setenv("MOSAIC_RASTER_LANE", "fold")
        monkeypatch.setenv("MOSAIC_TUNE_LOOKUP", "gather")
        ev, reng, eng = self.mk(ref_index, index, prof)
        assert ev["zonal_lane_source"] == "env" and eng.lane == "fold"
        assert ev["lookup_source"] == "env"

        ev, reng, eng = self.mk(ref_index, index, prof, lane="tiled",
                                probe="scatter")
        assert ev["zonal_lane_source"] == "explicit" and eng.lane == "tiled"
        assert ev["probe_source"] == "explicit" and eng.probe == "scatter"

    @pytest.mark.parametrize("lane", ["fold", "tiled"])
    def test_profiled_zones_equal_the_reference(self, ref_index, index, lane):
        """A profile's lane gives the reference's zones bit for bit at
        the same tile."""
        prof = pprof(zonal_lane=lane)
        _, reng, eng = self.mk(ref_index, index, prof)
        want = reng.zones(_mk_raster(RefRaster), tile=(32, 32))
        got = eng.zones(_mk_raster(Raster), tile=(32, 32))
        for f in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))

    def test_profile_tile_is_the_call_default(self, index, monkeypatch):
        """The port reads the profile's ``raster_tile`` where a call passes
        no tile: the zones equal an explicit call at that tile, and an
        explicit tile or ``MOSAIC_RASTER_TILE`` beats it."""
        r = _mk_raster(Raster)
        seen = []
        from mosaic_tpu_torch.raster import zonal as TZ

        real = TZ.plan_tiles
        monkeypatch.setattr(TZ, "plan_tiles",
                            lambda raster, tile=None: seen.append(tile) or real(raster, tile))
        eng = ZonalEngine(CUSTOM, RES, chip_index=index, device="cpu",
                          profile=pprof(zonal_lane="tiled", raster_tile=(16, 16)))
        got = eng.zones(r)
        want = ZonalEngine(CUSTOM, RES, chip_index=index, device="cpu",
                           lane="tiled").zones(r, tile=(16, 16))
        for f in ("keys", "count", "sum", "min", "max"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        eng.zones(r, tile=(32, 32))
        monkeypatch.setenv("MOSAIC_RASTER_TILE", "8x8")
        eng.grid(r)
        assert seen[0] == (16, 16) and seen[2] == (32, 32) and seen[3] == (8, 8)


class TestRasterStreamPrecedence:
    def test_constructor_knobs(self, ref_index, index, monkeypatch):
        prof = pprof(probe="scatter", lookup="gather")

        def mk(**kw):
            return both_events(
                lambda: RefRasterStream(ref_index, REF_CUSTOM, RES,
                                        profile=_ref_profile(prof), **kw),
                lambda: RasterStream(index, CUSTOM, RES, profile=prof, **kw),
                "raster_stream",
            )[0]

        ev = mk()
        assert ev["probe_source"] == "profile"
        assert ev["lookup_source"] == "profile"
        monkeypatch.setenv("MOSAIC_TUNE_PROBE", "adaptive")
        assert mk()["probe_source"] == "env"
        assert mk(probe="scatter")["probe_source"] == "explicit"

    def test_scan_knobs(self, ref_index, index, monkeypatch):
        prof = pprof(raster_tile=(32, 32), stream_window=2)
        rrs = RefRasterStream(ref_index, REF_CUSTOM, RES,
                              profile=_ref_profile(prof))
        rs = RasterStream(index, CUSTOM, RES, profile=prof)

        def scan(**kw):
            ev, want, got = both_events(
                lambda: rrs.scan(_mk_raster(RefRaster), **kw),
                lambda: rs.scan(_mk_raster(Raster), **kw),
                "raster_stream.scan",
            )
            for f in ("keys", "count", "sum", "min", "max"):
                np.testing.assert_array_equal(
                    getattr(got.stats, f), np.asarray(getattr(want.stats, f)))
            assert got.ntiles == want.ntiles
            return ev, got

        ev, out_prof = scan()
        assert ev["raster_tile_source"] == "profile"
        assert ev["stream_window_source"] == "profile"

        monkeypatch.setenv("MOSAIC_RASTER_TILE", "16x16")
        ev, out_env = scan()
        assert ev["raster_tile_source"] == "env" and ev["raster_tile"] == "(16, 16)"
        monkeypatch.delenv("MOSAIC_RASTER_TILE")

        ev, out_expl = scan(tile=(32, 32))
        assert ev["raster_tile_source"] == "explicit"
        # the tile shape is a schedule knob: answers are tile-invariant
        np.testing.assert_array_equal(out_prof.stats.keys, out_expl.stats.keys)
        np.testing.assert_array_equal(out_env.stats.count, out_expl.stats.count)


# ---------------------------------------------------------- profile store


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """Each store contract runs in both packages."""
    return RT if request.param == "reference" else T


class TestProfileStore:
    def prof(self, pkg, **kw):
        kw = kw or dict(resolution=5, probe="adaptive", batch_size=2048)
        return pkg.TuningProfile(**kw)

    def test_roundtrip(self, pkg, tmp_path):
        store = pkg.ProfileStore(str(tmp_path))
        store.save(self.prof(pkg), fingerprint="abc123")
        store.save(pkg.TuningProfile(resolution=6), fingerprint="abc123")
        assert store.versions() == [1, 2]
        prof, payload = store.load_latest()
        assert prof.resolution == 6
        assert payload["profile_version"] == 2
        assert payload["fingerprint"] == "abc123"

    def test_empty_store_is_typed(self, pkg, tmp_path):
        with pytest.raises(pkg.ProfileStoreCorrupt, match="no tuning profile"):
            pkg.ProfileStore(str(tmp_path / "nope")).load_latest()

    def test_corrupt_newest_skips_to_older_valid(self, pkg, tmp_path):
        store = pkg.ProfileStore(str(tmp_path))
        store.save(self.prof(pkg))
        p2 = store.save(pkg.TuningProfile(resolution=9))
        with open(p2, "w") as f:
            f.write("{ not json")
        tel = ref_telemetry if pkg is RT else telemetry
        with tel.capture() as events:
            prof, payload = store.load_latest()
        assert prof.resolution == 5 and payload["profile_version"] == 1
        skipped = [e for e in events
                   if e.get("event") == "tune_profile_corrupt_skipped"]
        assert len(skipped) == 1 and skipped[0]["profile_version"] == 2

    def test_checksum_tamper_is_corrupt(self, pkg, tmp_path):
        store = pkg.ProfileStore(str(tmp_path))
        path = store.save(self.prof(pkg))
        payload = json.loads(open(path).read())
        payload["profile"]["batch_size"] = 4  # tamper without re-hashing
        with open(path, "w") as f:
            json.dump(payload, f)
        with pytest.raises(pkg.ProfileStoreCorrupt, match="failed validation"):
            store.load_latest()

    def test_unknown_format_version_is_corrupt(self, pkg, tmp_path):
        store = pkg.ProfileStore(str(tmp_path))
        path = store.save(self.prof(pkg))
        payload = json.loads(open(path).read())
        payload["version"] = 99
        with open(path, "w") as f:
            json.dump(payload, f)
        with pytest.raises(pkg.ProfileStoreCorrupt):
            store.load_latest()

    def test_fingerprint_mismatch_is_refusal_not_fallback(self, pkg, tmp_path):
        store = pkg.ProfileStore(str(tmp_path))
        store.save(self.prof(pkg), fingerprint="good")
        store.save(pkg.TuningProfile(resolution=9), fingerprint="stale")
        with pytest.raises(pkg.ProfileFingerprintMismatch, match="re-profile"):
            store.load_latest(expect_fingerprint="good")

    def test_fingerprint_match_loads(self, pkg, tmp_path, ref_index, index):
        store = pkg.ProfileStore(str(tmp_path))
        fp = pkg.index_fingerprint(ref_index if pkg is RT else index)
        store.save(self.prof(pkg), fingerprint=fp)
        prof, payload = store.load_latest(expect_fingerprint=fp)
        assert prof.resolution == 5 and payload["fingerprint"] == fp

    def test_orphan_tmp_never_shadows(self, pkg, tmp_path):
        store = pkg.ProfileStore(str(tmp_path))
        store.save(self.prof(pkg))
        open(os.path.join(str(tmp_path), "profile-v0002.json.tmp"), "w").close()
        assert store.versions() == [1]
        prof, _ = store.load_latest()
        assert prof.resolution == 5


class TestStoresAcrossPackages:
    FULL = dict(resolution=5, probe="adaptive", writeback="scatter",
                lookup="gather", batch_size=2048, bucket_min=128,
                bucket_max=2048, stream_window=3, stream_pipeline=False,
                raster_tile=(128, 128), zonal_lane="tiled",
                overlay_lane="host", knn_lane="ring",
                rationale=[{"knob": "probe", "value": "adaptive",
                            "rule": "dense-share-router",
                            "evidence": {"heavy": 0.5}}],
                source={"priors": ["KNN_x.json"]})

    @pytest.mark.parametrize("writer,reader", [(RT, T), (T, RT)],
                             ids=["reference-to-port", "port-to-reference"])
    def test_each_package_loads_the_others_store(self, tmp_path, ref_index,
                                                 index, writer, reader):
        fp = T.index_fingerprint(index)
        path = writer.ProfileStore(str(tmp_path)).save(
            writer.TuningProfile(**self.FULL), fingerprint=fp)
        prof, payload = reader.ProfileStore(str(tmp_path)).load_latest(
            expect_fingerprint=fp)
        assert isinstance(prof, reader.TuningProfile)
        assert prof.as_dict() == writer.TuningProfile(**self.FULL).as_dict()
        assert payload["profile_version"] == 1

    def test_saved_files_are_byte_equal(self, tmp_path, index):
        fp = T.index_fingerprint(index)
        a = RT.ProfileStore(str(tmp_path / "r")).save(
            RT.TuningProfile(**self.FULL), fingerprint=fp)
        b = T.ProfileStore(str(tmp_path / "p")).save(
            T.TuningProfile(**self.FULL), fingerprint=fp)
        assert open(a, "rb").read() == open(b, "rb").read()

    def test_fingerprint_equals_the_reference_and_the_cpu_copy(self, ref_index,
                                                                index):
        assert T.index_fingerprint(index) == RT.index_fingerprint(ref_index)
        host = types.SimpleNamespace(cells=index.cells.numpy().copy())
        assert T.index_fingerprint(index) == T.index_fingerprint(host)


# -------------------------------------------------------------- hot swap


class TestHotSwap:
    def test_swap_changes_resolution_without_cold_compiles(
        self, zones, ref_zones, index, points
    ):
        fine = TJ.build_chip_index(
            tessellate(zones, CUSTOM, RES + 1, keep_core_geoms=False),
            device="cpu",
        )
        prof = pprof(resolution=RES + 1, probe="scatter",
                     bucket_min=64, bucket_max=512)
        q = points[:400]
        with ServeEngine(index, CUSTOM, RES, ladder=BucketLadder(64, 512),
                         max_wait_s=0.001) as eng:
            eng.warmup()
            eng.join(q, timeout=30.0)  # traffic on the old core
            with telemetry.capture() as events:
                stats = eng.hot_swap(fine, profile=prof)
            assert stats["buckets"] == len(eng.ladder.buckets)
            assert eng.resolution == RES + 1
            assert [e for e in events if e.get("event") == "serve_swap"]
            (ev,) = resolve_events(events, "serve_engine.hot_swap")
            assert ev["resolution_source"] == "profile" and ev["profiled"]
            post = np.asarray(eng.join(q, timeout=30.0))
            assert eng.metrics()["cold_compiles"] == 0
        ref_fine = RJ.build_chip_index(
            ref_tessellate(ref_zones, REF_CUSTOM, RES + 1, keep_core_geoms=False))
        want = np.asarray(RJ.pip_join(
            q, None, REF_CUSTOM, RES + 1, chip_index=ref_fine, recheck=False,
            probe="scatter",
        ))
        np.testing.assert_array_equal(post.astype(np.int64),
                                      want.astype(np.int64))

    def test_profileless_swap_keeps_tuning(self, index):
        with ServeEngine(index, CUSTOM, RES, ladder=BucketLadder(64, 256),
                         probe="scatter") as eng:
            eng.warmup()
            eng.hot_swap(index)
            assert eng.resolution == RES
            assert eng.probe == "scatter"
            assert eng.ladder.buckets == (64, 128, 256)
            assert eng.metrics()["cold_compiles"] == 0

    def test_swap_event_equals_the_reference(self, ref_index, index):
        prof = pprof(probe="adaptive", bucket_min=64, bucket_max=128,
                     writeback="gather")

        def ref_call():
            with RefServeEngine(ref_index, REF_CUSTOM, RES,
                                ladder=RefLadder(64, 128)) as eng:
                eng.hot_swap(ref_index, profile=_ref_profile(prof),
                             resolution=RES)

        def port_call():
            with ServeEngine(index, CUSTOM, RES,
                             ladder=BucketLadder(64, 128)) as eng:
                eng.hot_swap(index, profile=prof, resolution=RES)
                return eng.probe, eng.writeback, eng.ladder.buckets

        ev, _, got = both_events(ref_call, port_call, "serve_engine.hot_swap")
        assert got == ("adaptive", "gather", (64, 128))
        assert ev["resolution_source"] == "explicit"
        assert ev["probe_source"] == ev["bucket_max_source"] == "profile"


# ------------------------------------------------- profiler + recommend


class TestProfiler:
    def test_points_profile_equals_the_reference(self, ref_index, index, points):
        with ref_telemetry.capture() as rev:
            want = RT.profile_points(points, ref_index, REF_CUSTOM, RES, sample=512)
        with telemetry.capture() as pev:
            prof = T.profile_points(points, index, CUSTOM, RES, sample=512)
        assert prof.as_dict() == want.as_dict()
        assert prof.kind == "points" and prof.n_sampled == 512
        assert 0.0 < prof.match_rate <= 1.0
        assert abs(sum(prof.class_shares.values()) - 1.0) < 1e-9
        assert prof.chip_density["p50"] >= 1.0
        assert prof.band_fraction is not None
        assert 0.0 <= prof.band_fraction <= 1.0
        strip = lambda evs: [{k: v for k, v in e.items() if k not in VOLATILE}  # noqa: E731
                             for e in evs if e["event"] in ("tune_profile", "tune_stage")]
        assert strip(pev) == strip(rev) and len(strip(pev)) == 2
        assert T.WorkloadProfile.from_dict(prof.as_dict()) == prof

    def test_points_profile_reads_each_table_once(self, index, points, monkeypatch):
        """Each index table is copied to the host whole, once a call."""
        from mosaic_tpu_torch.tune import profiler

        calls = []
        real = profiler._host
        monkeypatch.setattr(profiler, "_host",
                            lambda a: calls.append(type(a).__name__) or real(a))
        T.profile_points(torch.from_numpy(points), index, CUSTOM, RES, sample=512)
        assert calls.count("Tensor") == 5  # points + 4 index tables

    def test_whole_sample_profile_equals_the_reference(self, ref_index, index,
                                                       points):
        want = RT.profile_points(points, ref_index, REF_CUSTOM, RES)
        got = T.profile_points(points, index, CUSTOM, RES)
        assert got.as_dict() == want.as_dict() and got.n_sampled == 2048

    def test_polygons_profile_equals_the_reference(self, ref_zones, zones):
        want = RT.profile_polygons(ref_zones, REF_CUSTOM)
        prof = T.profile_polygons(zones, CUSTOM)
        assert prof.as_dict() == want.as_dict()
        assert prof.kind == "polygons"
        assert isinstance(prof.optimal_resolution, int)
        assert prof.cells_per_geom["mean"] > 0

    def test_raster_profile_equals_the_reference(self):
        want = RT.profile_raster(_mk_raster(RefRaster), tile=(32, 32))
        prof = T.profile_raster(_mk_raster(Raster), tile=(32, 32))
        assert prof.as_dict() == want.as_dict()
        assert prof.kind == "raster"
        assert 0.0 <= prof.tile_occupancy <= 1.0
        assert 0.4 < prof.nodata_fraction < 0.6  # 50% speckle by seed


def _profiles(ref_zones, zones, ref_index, index, points):
    """(reference, port) pairs of the fixture's polygon and point
    profiles."""
    return (
        (RT.profile_polygons(ref_zones, REF_CUSTOM), T.profile_polygons(zones, CUSTOM)),
        (RT.profile_points(points, ref_index, REF_CUSTOM, RES),
         T.profile_points(points, index, CUSTOM, RES)),
    )


def _same_rec(rwp, pwp, priors=None):
    """Both packages' recommendation for the same profile, asserted
    equal (knobs, rationale, source); returns the port's."""
    priors = {} if priors is None else priors
    rrec = RT.recommend(RT.WorkloadProfile.from_dict(rwp.as_dict()), priors=priors)
    prec = T.recommend(T.WorkloadProfile.from_dict(pwp.as_dict()), priors=priors)
    assert prec.as_dict() == rrec.as_dict()
    return prec


class TestRecommend:
    def test_rationale_is_machine_checkable(self, ref_zones, zones, ref_index,
                                            index, points):
        (rpoly, poly), (rpts, pts) = _profiles(ref_zones, zones, ref_index,
                                               index, points)
        poly_rec, pts_rec = _same_rec(rpoly, poly), _same_rec(rpts, pts)
        merged = T.TuningProfile.merged(poly_rec, pts_rec)
        rmerged = RT.TuningProfile.merged(
            RT.recommend(rpoly, priors={}), RT.recommend(rpts, priors={}))
        assert merged.as_dict() == rmerged.as_dict()
        assert merged.resolution == poly_rec.resolution
        assert merged.probe == pts_rec.probe
        assert merged.rationale and all(
            {"knob", "value", "rule", "evidence"} <= set(r)
            for r in merged.rationale
        )
        recommended = {
            k for k, v in merged.as_dict().items()
            if k not in ("rationale", "source") and v is not None
        }
        assert {r["knob"] for r in merged.rationale} == recommended

    def test_recommend_event_equals_the_reference(self):
        prof = dict(kind="points", n_sampled=4096, n_total=10 ** 6,
                    class_shares={"heavy": 0.3, "convex": 0.1, "light": 0.6})
        with ref_telemetry.capture() as rev:
            RT.recommend(RT.WorkloadProfile(**prof), priors={})
        with telemetry.capture() as pev:
            T.recommend(T.WorkloadProfile(**prof), priors={})
        strip = lambda evs: [{k: v for k, v in e.items() if k not in VOLATILE}  # noqa: E731
                             for e in evs if e["event"] in ("tune_recommend", "tune_stage")]
        assert strip(pev) == strip(rev) and len(strip(pev)) == 2

    @pytest.mark.parametrize("shares,probe,rule", [
        ({"heavy": 0.3, "convex": 0.1, "light": 0.6}, "adaptive", "dense-share-router"),
        ({"heavy": 0.05, "convex": 0.05, "light": 0.9}, "scatter",
         "light-dominated-single-lane"),
    ], ids=["dense_share_routes_adaptive", "light_share_routes_scatter"])
    def test_share_routes_probe(self, shares, probe, rule):
        prof = T.WorkloadProfile(kind="points", n_sampled=4096, class_shares=shares)
        rec = _same_rec(prof, prof)
        assert rec.probe == probe
        (r,) = [r for r in rec.rationale if r["knob"] == "probe"]
        assert r["rule"] == rule

    @pytest.mark.parametrize("n_total,batch,lo", [
        (2048, 1024, 64), (10 ** 6, 131072 // 2, 4096), (4 * 10 ** 6, 65536, 4096),
    ])
    def test_batch_and_ladder_from_the_workload_size(self, n_total, batch, lo):
        prof = T.WorkloadProfile(kind="points", n_sampled=4096, n_total=n_total,
                                 class_shares={"heavy": 0.5, "convex": 0.0,
                                               "light": 0.5})
        rec = _same_rec(prof, prof)
        assert rec.batch_size == rec.bucket_max == batch
        assert rec.bucket_min == lo

    def test_band_fraction_pins_fold_lane(self):
        prof = T.WorkloadProfile(kind="points", n_sampled=64, band_fraction=0.2)
        assert _same_rec(prof, prof).zonal_lane == "fold"

    def test_sparse_raster_shrinks_tiles(self):
        sparse = T.WorkloadProfile(kind="raster", n_sampled=9, tile_occupancy=0.2)
        dense = T.WorkloadProfile(kind="raster", n_sampled=9, tile_occupancy=0.9)
        assert _same_rec(sparse, sparse).raster_tile == (128, 128)
        assert _same_rec(dense, dense).raster_tile == (256, 256)

    def test_stream_prior_sets_window(self):
        priors = {"artifacts": {"STREAM_CPU_r99.json": {
            "detail": {"pipeline": {"window": 6, "speedup_vs_sync": 1.2}}
        }}}
        prof = T.WorkloadProfile(kind="points", n_sampled=0)
        rec = _same_rec(prof, prof, priors)
        assert rec.stream_window == 6 and rec.stream_pipeline is True

    def test_stream_prior_can_disable_pipeline(self):
        priors = {"artifacts": {"STREAM_CPU_r99.json": {
            "detail": {"pipeline": {"window": 4, "speedup_vs_sync": 0.8}}
        }}}
        prof = T.WorkloadProfile(kind="points", n_sampled=0)
        assert _same_rec(prof, prof, priors).stream_pipeline is False

    @pytest.mark.parametrize("speedup,lane", [(None, "voronoi"), (0.5, "ring"),
                                              (1.2, "voronoi")])
    def test_knn_prior_decides_the_lane(self, speedup, lane):
        priors = {"artifacts": {}} if speedup is None else {"artifacts": {
            "KNN_x.json": {"detail": {"voronoi_speedup_vs_ring": speedup}}}}
        prof = T.WorkloadProfile(kind="points", n_sampled=64,
                                 class_shares={"heavy": 0.0, "convex": 0.8,
                                               "light": 0.2})
        assert _same_rec(prof, prof, priors).knn_lane == lane

    @pytest.mark.parametrize("n,speedup,lane", [(100, None, "host"),
                                                (5000, None, "device"),
                                                (5000, 0.5, "host")])
    def test_overlay_prior_decides_the_lane(self, n, speedup, lane):
        priors = {"artifacts": {}} if speedup is None else {"artifacts": {
            "OVERLAY_x.json": {"detail": {"speedup_vs_host": speedup}}}}
        prof = T.WorkloadProfile(kind="overlay", n_sampled=n, resolution=3,
                                 sure_fraction=0.9, border_fraction=0.1)
        assert _same_rec(prof, prof, priors).overlay_lane == lane


# ------------------------------------------------------------- priors


class TestPriors:
    def test_default_priors_are_the_ports_folder_only(self, monkeypatch, tmp_path):
        import importlib

        TR = importlib.import_module("mosaic_tpu_torch.tune.recommend")
        here = os.path.dirname(os.path.abspath(TR.__file__))
        assert str(TR.PRIORS_DIR) == os.path.join(here, "priors")
        names = sorted(
            n for n in os.listdir(TR.PRIORS_DIR)
            if n.endswith(".json")
        )
        assert names and sorted(T.load_priors()["artifacts"]) == names
        # the repository root's TPU and CPU rounds are not read
        root = os.path.dirname(os.path.dirname(here))
        assert "TREND.json" in os.listdir(root)
        assert not set(T.load_priors()["artifacts"]) & set(os.listdir(root))
        # a given root reads as the reference reads it
        (tmp_path / "KNN_r01.json").write_text('{"detail": {}}')
        (tmp_path / "OTHER.json").write_text("{}")
        assert T.load_priors(tmp_path) == RT.load_priors(tmp_path)

    def test_every_prior_names_an_nvidia_card(self):
        arts = T.load_priors()["artifacts"]
        assert {n.split("_")[0] for n in arts} >= {"KNN", "OVERLAY"}
        for name, art in arts.items():
            dev = art["device"]
            assert dev["name"].startswith("NVIDIA"), name
            assert dev["power_limit"].endswith("W"), name
            assert art["source"].startswith("chip_smoke.py"), name

    def test_card_priors_keep_knn_on_the_ring_lane(self):
        """The card measured the Voronoi lane slower than the ring lane,
        so a convex-heavy workload stays on the ring lane (the
        reference's repository-root prior would pick Voronoi)."""
        arts = T.load_priors()["artifacts"]
        (speed,) = [a["detail"]["voronoi_speedup_vs_ring"]
                    for n, a in arts.items() if n.startswith("KNN_")]
        prof = T.WorkloadProfile(kind="points", n_sampled=64,
                                 class_shares={"heavy": 0.0, "convex": 0.9,
                                               "light": 0.1})
        rec = T.recommend(prof)
        (r,) = [r for r in rec.rationale if r["knob"] == "knn_lane"]
        assert r["evidence"]["voronoi_speedup_vs_ring"] == speed
        assert rec.knn_lane == ("ring" if speed < 1.0 else "voronoi")


# ------------------------------------------------------------ router


class TestRouterProfiles:
    def router(self):
        return ServeRouter(CUSTOM, engine_defaults={
            "ladder": BucketLadder(64, 256), "bounds": BBOX, "max_wait_s": 0.01,
        })

    def test_explicit_profile_tunes_the_tenant(self, index, points):
        with self.router() as router:
            with telemetry.capture() as ev:
                router.add_tenant("a", index, RES,
                                  profile=pprof(probe="adaptive"), ladder=None)
            (added,) = [e for e in ev if e["event"] == "router_tenant_added"]
            assert added["profiled"] is True
            eng = router._tenants["a"].engine
            assert eng.probe == "adaptive"
            got = np.asarray(router.join("a", points[:300], timeout=30.0))
        want = TJ.pip_join(points[:300], None, CUSTOM, RES, chip_index=index,
                           recheck=False, device="cpu")
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))

    def test_good_store_loads(self, index, tmp_path):
        T.ProfileStore(str(tmp_path)).save(
            pprof(probe="adaptive", writeback="gather"),
            fingerprint=T.index_fingerprint(index))
        with self.router() as router:
            router.add_tenant("a", index, RES, profile_root=str(tmp_path))
            eng = router._tenants["a"].engine
            assert (eng.probe, eng.writeback) == ("adaptive", "gather")
            assert router._tenants["a"].profile.probe == "adaptive"

    def test_reference_store_loads(self, ref_index, index, tmp_path):
        RT.ProfileStore(str(tmp_path)).save(
            RT.TuningProfile(probe="adaptive"),
            fingerprint=RT.index_fingerprint(ref_index))
        with self.router() as router:
            router.add_tenant("a", index, RES, profile_root=str(tmp_path))
            assert router._tenants["a"].engine.probe == "adaptive"

    @pytest.mark.parametrize("damage", ["corrupt", "mismatched", "empty"])
    def test_bad_store_serves_untuned(self, index, points, tmp_path, damage):
        store = T.ProfileStore(str(tmp_path))
        if damage != "empty":
            fp = "0" * 64 if damage == "mismatched" else T.index_fingerprint(index)
            path = store.save(pprof(probe="adaptive"), fingerprint=fp)
            if damage == "corrupt":
                with open(path, "w") as f:
                    f.write("{ torn")
        with self.router() as router:
            with telemetry.capture() as ev:
                router.add_tenant("a", index, RES, profile_root=str(tmp_path))
            (fb,) = [e for e in ev if e["event"] == "router_profile_fallback"]
            assert fb["tenant"] == "a"
            want_err = ("ProfileFingerprintMismatch" if damage == "mismatched"
                        else "ProfileStoreCorrupt")
            assert fb["error"].startswith(want_err)
            assert router._tenants["a"].profile is None
            assert router._tenants["a"].engine.probe == "scatter"
            got = np.asarray(router.join("a", points[:200], timeout=30.0))
        want = TJ.pip_join(points[:200], None, CUSTOM, RES, chip_index=index,
                           recheck=False, device="cpu")
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


# ---------------------------------------------------------- re-profiling

#: zones an order of magnitude larger than the fixture's, so the analyzer
#: picks a resolution other than RES for them
BIG = [
    "POLYGON ((-24 -24, 10 -24, 10 10, -24 10, -24 -24))",
    "POLYGON ((12 -20, 34 -20, 34 18, 12 18, 12 -20))",
]


class TestReprofile:
    def epochal(self, wkts=BIG):
        return EpochalIndex(port_col(wkt.from_wkt(wkts)), CUSTOM, RES,
                            keep_core_geoms=False, device="cpu")

    def test_reprofile_equals_the_reference(self):
        from mosaic_tpu.index import EpochalIndex as RefEpochalIndex

        ref = RefEpochalIndex(wkt.from_wkt(BIG), REF_CUSTOM, RES,
                              keep_core_geoms=False)
        with ref_telemetry.capture() as rev:
            want = RT.recommend(RT.profile_polygons(ref.column(), REF_CUSTOM),
                                priors=T.load_priors())
        with telemetry.capture() as pev:
            got = self.epochal().reprofile()
        assert got.as_dict() == want.as_dict()
        assert got.resolution != RES  # the analyzer's pick, not the index's
        assert [e for e in pev if e["event"] == "epoch_reprofile"]
        assert [e for e in rev if e["event"] == "tune_profile"]

    def test_publish_keeps_the_index_resolution(self, points, monkeypatch):
        """``publish(reprofile=True)`` swaps at the epochal index's own
        resolution although the profile recommends another; the profile's
        other knobs (probe, ladder) apply, and every answer equals
        `pip_join` of the new epoch."""
        ep = self.epochal()
        ep.publish()
        pick = ep.reprofile().resolution
        assert pick != RES
        monkeypatch.setattr(
            EpochalIndex, "reprofile",
            lambda self: pprof(resolution=pick, probe="adaptive",
                               bucket_min=64, bucket_max=128),
        )
        with ServeEngine(ep.index, CUSTOM, RES, ladder=BucketLadder(64, 256),
                         bounds=BBOX, max_wait_s=0.001) as eng:
            eng.warmup()
            ep.apply(upsert=port_col(wkt.from_wkt(ZONES[:1])), ids=[0])
            with telemetry.capture() as ev:
                stats = ep.publish(eng, reprofile=True)
            assert stats["reprofiled"] is True and ep.epoch == 1
            (swap,) = resolve_events(ev, "serve_engine.hot_swap")
            assert swap["resolution"] == RES
            assert swap["resolution_source"] == "explicit"
            assert swap["probe_source"] == "profile"
            assert eng.resolution == RES and eng.probe == "adaptive"
            assert eng.ladder.buckets == (64, 128)
            got = np.asarray(eng.join(points[:128], timeout=30.0))
            assert eng.metrics()["cold_compiles"] == 0
        want = TJ.pip_join(points[:128], None, CUSTOM, RES, chip_index=ep.index,
                           recheck=False, device="cpu")
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
        assert (want >= 0).any()

    def test_advance_epoch_reprofile_serves_exact_answers(self, points):
        ep = self.epochal()
        ep.publish()
        with ServeRouter(CUSTOM, engine_defaults={
            "ladder": BucketLadder(64, 256), "bounds": BBOX, "max_wait_s": 0.01,
        }) as router:
            router.add_tenant("a", ep.index, RES)
            ep.apply(remove=[1])
            with telemetry.capture() as ev:
                stats = router.advance_epoch("a", ep, reprofile=True)
            assert stats["reprofiled"] is True and stats["epoch"] == 1
            assert [e for e in ev if e["event"] == "epoch_reprofile"]
            assert router._tenants["a"].engine.resolution == RES
            got = np.asarray(router.join("a", points[:256], timeout=30.0))
            assert router.metrics()["tenants"]["a"]["epoch_advances"] == 1
        want = TJ.pip_join(points[:256], None, CUSTOM, RES, chip_index=ep.index,
                           recheck=False, device="cpu")
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))

    def test_reference_swaps_to_the_profiles_resolution(self):
        """The reference fault the port does not carry over (ROADMAP
        queue 3): its reprofiled publish hands ``hot_swap`` the profile
        alone, so its engine takes the analyzer's resolution."""
        from mosaic_tpu.index import EpochalIndex as RefEpochalIndex

        ref = RefEpochalIndex(wkt.from_wkt(BIG), REF_CUSTOM, RES,
                              keep_core_geoms=False)
        ref.publish()

        class Spy:
            kw = None

            def hot_swap(self, index, **kw):
                Spy.kw = kw

        ref.apply(remove=[1])
        ref.publish(Spy(), reprofile=True)
        assert "resolution" not in Spy.kw
        assert Spy.kw["profile"].resolution != RES

        ep = self.epochal()
        ep.publish()
        ep.apply(remove=[1])
        ep.publish(Spy(), reprofile=True)
        assert Spy.kw["resolution"] == RES
        assert Spy.kw["profile"].resolution != RES


# ------------------------------------------------------------ overlay


class TestOverlayCandidateTelemetry:
    def strip(self, events):
        return [{k: v for k, v in e.items() if k not in VOLATILE}
                for e in events if e.get("event") == "overlay_candidates"]

    def test_stats_recorded(self, ref_zones, zones):
        rleft = ref_tessellate(ref_zones, REF_CUSTOM, RES, keep_core_geoms=False)
        left = tessellate(zones, CUSTOM, RES, keep_core_geoms=False)
        with ref_telemetry.capture() as rev:
            ref_candidate_pairs(rleft, rleft)
        with telemetry.capture() as events:
            lrows, rrows, sure = candidate_pairs(left, left)
        (ev,) = self.strip(events)
        assert [ev] == self.strip(rev)
        assert ev["candidates"] == int(lrows.shape[0]) > 0
        assert 0.0 <= ev["sure_fraction"] <= 1.0
        assert abs(ev["sure_fraction"] + ev["border_fraction"] - 1.0) < 1e-6
        assert ev["sure_fraction"] == pytest.approx(
            float(sure.sum()) / sure.shape[0], abs=1e-6
        )

    def test_disjoint_tables_record_zeros(self, zones):
        left = tessellate(zones, CUSTOM, RES, keep_core_geoms=False)
        far = port_col(wkt.from_wkt(
            ["POLYGON ((100 50, 110 50, 110 60, 100 60, 100 50))"]))
        right = tessellate(far, CUSTOM, RES, keep_core_geoms=False)
        with telemetry.capture() as events:
            lrows, _, _ = candidate_pairs(left, right)
        assert lrows.shape[0] == 0
        (ev,) = self.strip(events)
        assert ev["candidates"] == 0 and ev["sure_fraction"] == 0.0


class TestOverlayProfile:
    def test_overlay_profile_consumes_span_stats(self, ref_zones, zones):
        want = RT.profile_overlay(ref_zones, ref_zones, REF_CUSTOM, RES)
        with telemetry.capture() as events:
            prof = T.profile_overlay(zones, zones, CUSTOM, RES)
        assert prof.as_dict() == want.as_dict()
        assert prof.kind == "overlay" and prof.n_sampled > 0
        assert prof.resolution == RES
        assert abs(prof.sure_fraction + prof.border_fraction - 1.0) < 1e-6
        assert [e for e in events if e.get("event") == "tune_profile"]
        assert T.WorkloadProfile.from_dict(prof.as_dict()) == prof

    def test_prebuilt_chip_tables_are_used(self, zones):
        lt = tessellate(zones, CUSTOM, RES, keep_core_geoms=False)
        a = T.profile_overlay(None, None, CUSTOM, RES, left_chips=lt, right_chips=lt)
        b = T.profile_overlay(zones, zones, CUSTOM, RES)
        assert a == b

    @pytest.mark.parametrize("border,res", [(0.8, 4), (0.1, None)],
                             ids=["border_dominated_finer", "sure_dominated_keeps"])
    def test_border_share_decides_the_resolution(self, border, res):
        prof = T.WorkloadProfile(kind="overlay", n_sampled=100, resolution=3,
                                 sure_fraction=1.0 - border,
                                 border_fraction=border)
        rec = _same_rec(prof, prof)
        assert rec.resolution == res
        rules = [r for r in rec.rationale if r["knob"] == "resolution"]
        if res is None:
            assert not rules
        else:
            (rule,) = rules
            assert rule["rule"] == "border-dominated-finer-tessellation"
            assert rule["evidence"]["border_fraction"] == border
            assert rule["evidence"]["threshold"] == 0.5
