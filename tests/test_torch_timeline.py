"""The port's timeline attribution (`mosaic_tpu_torch/obs/timeline.py`):
interval reconstruction, the priority sweep's exact partition, stall
classification, and the stall report over a REAL durable stream run of
the port on the CPU.

Mirrors `tests/test_timeline.py` case for case. Beyond the mirror: the
port's ``attribute`` gives the reference's class seconds exactly (and
its ``build_tracks`` the same tracks) on seeded synthetic trails and on
the port's own stream trail.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from mosaic_tpu.obs import timeline as ref_timeline
from mosaic_tpu_torch.obs import export, timeline
from mosaic_tpu_torch.runtime import telemetry
from mosaic_tpu_torch.tools import stall_report
from torch_obs_fixtures import reset_port_plane, synthetic_trail


@pytest.fixture(autouse=True)
def _fresh_plane():
    reset_port_plane()
    yield


def _span(name, start, seconds, seq=0, **attrs):
    return {
        "event": "span", "name": name, "start_mono": start,
        "seconds": seconds, "seq": seq, "ts_mono": start + seconds,
        **attrs,
    }


class TestKeysAndClasses:
    def test_event_key_conventions(self):
        assert timeline.event_key(
            {"event": "span", "name": "stream.segment", "seconds": 1}
        ) == "span.stream.segment"
        assert timeline.event_key(
            {"event": "serve_stage", "stage": "queue_wait", "seconds": 1}
        ) == "serve_stage.queue_wait"
        assert timeline.event_key(
            {"stage_key": "span.x", "seconds": 1}
        ) == "span.x"
        assert timeline.event_key(
            {"event": "recheck_narrow", "seconds": 0.1}
        ) == "recheck_narrow"
        assert timeline.event_key({"event": "snapshot_saved"}) is None

    @pytest.mark.parametrize("key,cls", [
        ("span.dispatch.transfer.h2d", "transfer"),
        ("span.dispatch.transfer.d2h", "transfer"),
        ("span.stream.ring_build", "transfer"),
        ("span.dispatch.compile", "compile"),
        ("stream_stage.compile", "compile"),
        ("stream_stage.gen_compile", "compile"),
        ("serve_stage.queue_wait", "queue_wait"),
        ("span.stream.snapshot", "host_callback"),
        ("span.raster.snapshot", "host_callback"),
        ("span.stream.segment", "device"),
        ("span.serve.dispatch", "device"),
        ("span.join.probe.scatter", "device"),
        ("probe_stage.heavy", "device"),
        ("raster_stage.zonal", "device"),
        ("span.stream.pipeline.drain", "device"),
        ("stream_stage.pipeline_drain", "device"),
        ("span.stream.pipeline.flush", "host_callback"),
        ("stream_stage.pipeline_flush", "host_callback"),
    ])
    def test_classifier_table(self, key, cls):
        assert timeline.classify_key(key) == cls

    @pytest.mark.parametrize("key,cls", [
        ("span.join.pip.h2d", "transfer"),
        ("span.join.pip.d2h", "transfer"),
        ("span.join.pip.prepare", "device"),
        ("span.join.pip.cells", "device"),
        ("span.join.pip.counts", "device"),
        ("span.join.pip.probe", "device"),
        ("span.stream.assign", "device"),
        ("span.stream.join", "device"),
        ("span.stream.fold_pull", "device"),
    ])
    def test_stage_span_classes(self, key, cls):
        # the port's stage spans (recorded only while stage timing is on)
        assert timeline.classify_key(key) == cls

    def test_containers_and_unknowns_stay_unclassified(self):
        for key in (
            "span.stream.durable_run", "stream_stage.durable_loop",
            "span.serve.request", "span.stream_bench",
            "stream_stage.single_batch", "no_such_key", None,
        ):
            assert timeline.classify_key(key) is None


class TestIntervals:
    def test_span_uses_start_mono(self):
        iv = timeline.interval_of(_span("x", 10.0, 2.5))
        assert iv == (10.0, 12.5)

    def test_flat_timed_event_ends_at_ts_mono(self):
        iv = timeline.interval_of(
            {"event": "serve_stage", "stage": "queue_wait",
             "seconds": 0.5, "ts_mono": 4.0}
        )
        assert iv == (3.5, 4.0)

    def test_instants_and_negative_seconds_are_skipped(self):
        assert timeline.interval_of({"event": "x", "ts_mono": 1.0}) is None
        assert timeline.interval_of(
            {"event": "x", "seconds": -1, "ts_mono": 1.0}
        ) is None


class TestFlattenPartition:
    def test_partition_sums_to_window_exactly(self):
        evts = [
            _span("stream.segment", 0.0, 1.0, seq=1),
            _span("dispatch.transfer.h2d", 0.4, 0.2, seq=2),
            _span("stream.snapshot", 1.1, 0.3, seq=3),
        ]
        segs = timeline.flatten(timeline.intervals(evts), (0.0, 2.0))
        total = sum(s["end"] - s["start"] for s in segs)
        assert total == pytest.approx(2.0, abs=1e-9)
        by_cls = {}
        for s in segs:
            by_cls[s["cls"]] = by_cls.get(s["cls"], 0.0) + (
                s["end"] - s["start"]
            )
        # transfer outranks the device span it nests inside
        assert by_cls["transfer"] == pytest.approx(0.2)
        assert by_cls["device"] == pytest.approx(0.8)
        assert by_cls["host_callback"] == pytest.approx(0.3)
        assert by_cls["idle"] == pytest.approx(0.7)

    def test_priority_order_under_total_overlap(self):
        evts = [
            _span("stream.segment", 0.0, 1.0, seq=1),
            _span("stream.snapshot", 0.0, 1.0, seq=2),
            _span("dispatch.transfer.h2d", 0.0, 1.0, seq=3),
            _span("dispatch.compile", 0.0, 1.0, seq=4),
        ]
        segs = timeline.flatten(timeline.intervals(evts), (0.0, 1.0))
        assert len(segs) == 1 and segs[0]["cls"] == "compile"

    def test_intervals_clip_to_window(self):
        evts = [_span("stream.segment", -1.0, 4.0)]
        segs = timeline.flatten(timeline.intervals(evts), (0.0, 2.0))
        assert segs == [{"start": 0.0, "end": 2.0, "cls": "device"}]

    def test_empty_window_returns_nothing(self):
        assert timeline.flatten([], (1.0, 1.0)) == []


class TestAttribute:
    def test_durable_loop_event_picks_the_window(self):
        evts = [
            _span("stream.segment", 0.5, 1.0, seq=1),
            {"event": "stream_stage", "stage": "durable_loop",
             "seconds": 2.0, "ts_mono": 2.0, "seq": 2},
        ]
        rep = timeline.attribute(evts)
        assert rep["window"]["source"] == "stream_stage.durable_loop"
        assert rep["wall_s"] == pytest.approx(2.0)
        assert rep["sum_s"] == pytest.approx(rep["wall_s"], abs=1e-6)
        assert rep["classes"]["device"]["seconds"] == pytest.approx(1.0)
        assert rep["classes"]["idle"]["seconds"] == pytest.approx(1.0)

    def test_envelope_fallback_without_loop_events(self):
        evts = [
            _span("serve.dispatch", 1.0, 0.5, seq=1),
            _span("serve.dispatch", 2.0, 0.5, seq=2),
        ]
        rep = timeline.attribute(evts)
        assert rep["window"]["source"] == "envelope"
        assert rep["wall_s"] == pytest.approx(1.5)
        assert rep["classes"]["idle"]["seconds"] == pytest.approx(0.5)

    def test_no_intervals_returns_none(self):
        assert timeline.attribute([{"event": "x", "ts_mono": 1.0}]) is None


class TestTracks:
    def test_tracks_merge_and_gap(self):
        evts = [
            _span("stream.segment", 0.0, 1.0, seq=1),
            _span("stream.segment", 1.5, 1.0, seq=2),
            _span("stream.segment", 1.6, 0.2, seq=3),
        ]
        tr = timeline.build_tracks(evts)["span.stream.segment"]
        assert tr["count"] == 3
        assert tr["intervals"] == [(0.0, 1.0), (1.5, 2.5)]
        assert tr["busy_s"] == pytest.approx(2.0)
        assert tr["gap_s"] == pytest.approx(0.5)

    def test_overlap_measures_pipeline_hiding(self):
        a = [(0.0, 1.0), (2.0, 3.0)]
        b = [(0.5, 2.5)]
        assert timeline.overlap_s(a, b) == pytest.approx(1.0)
        assert timeline.overlap_s(a, [(5.0, 6.0)]) == 0.0


class TestOverlappedTimelines:
    """The pipelined executor's claim as interval arithmetic: snapshot
    ``host_callback`` intervals that genuinely OVERLAP ``device``
    intervals (the writer thread runs while the next segments compute)
    must still flatten to an exact partition, and the pinned
    ``overlap_fraction`` helper turns "off the critical path" into a
    number the bench and CI lanes can gate."""

    def test_overlapping_snapshot_partition_still_exact(self):
        # device busy 0..2 (two back-to-back segments); the async
        # snapshot write covers 0.5..1.5 ENTIRELY inside device time —
        # the pipelined shape a synchronous loop can never produce
        evts = [
            _span("stream.segment", 0.0, 1.0, seq=1),
            _span("stream.segment", 1.0, 1.0, seq=2),
            _span("stream.snapshot", 0.5, 1.0, seq=3, mode="async"),
        ]
        segs = timeline.flatten(timeline.intervals(evts), (0.0, 2.0))
        total = sum(s["end"] - s["start"] for s in segs)
        assert total == pytest.approx(2.0, abs=1e-9)
        by_cls = {}
        for s in segs:
            by_cls[s["cls"]] = by_cls.get(s["cls"], 0.0) + (
                s["end"] - s["start"]
            )
        # host_callback outranks device for the overlapped second;
        # nothing is double-counted and nothing leaks to idle
        assert by_cls["host_callback"] == pytest.approx(1.0)
        assert by_cls["device"] == pytest.approx(1.0)
        assert "idle" not in by_cls

    def test_drain_and_flush_classes_sweep_exactly(self):
        # drain (device: the window's one blocking pull) overlapping
        # the writer's flush barrier (host_callback) at the run tail
        evts = [
            _span("stream.pipeline.drain", 0.0, 1.0, seq=1),
            _span("stream.pipeline.flush", 0.8, 0.6, seq=2),
        ]
        segs = timeline.flatten(timeline.intervals(evts), (0.0, 1.5))
        total = sum(s["end"] - s["start"] for s in segs)
        assert total == pytest.approx(1.5, abs=1e-9)
        by_cls = {
            s["cls"]: sum(
                x["end"] - x["start"] for x in segs
                if x["cls"] == s["cls"]
            )
            for s in segs
        }
        assert by_cls["device"] == pytest.approx(0.8)
        assert by_cls["host_callback"] == pytest.approx(0.6)
        assert by_cls.get("idle", 0.1) == pytest.approx(0.1)

    def test_overlap_fraction_pinned(self):
        dev = [(0.0, 1.0), (2.0, 3.0)]
        # fully hidden under device -> 1.0
        assert timeline.overlap_fraction([(0.2, 0.8)], dev) == 1.0
        # serialized after device (the synchronous loop) -> 0.0
        assert timeline.overlap_fraction([(1.0, 2.0)], dev) == 0.0
        # half in, half out
        assert timeline.overlap_fraction(
            [(0.5, 1.5)], dev
        ) == pytest.approx(0.5)
        # empty snapshot track -> 0.0, never a ZeroDivisionError
        assert timeline.overlap_fraction([], dev) == 0.0

    def test_pipelined_run_emits_drain_intervals(self, stream_setup, tmp_path):
        sj, ring = stream_setup
        with telemetry.capture() as events:
            sj.run_durable(
                ring, 6, run_dir=str(tmp_path), snapshot_every=2,
                pipeline=True,
            )
        rep = timeline.attribute(events)
        assert rep["window"]["source"] == "stream_stage.durable_loop"
        # the partition invariant holds for a REAL overlapped trail
        # (writer-thread snapshot spans + main-thread drain spans)
        assert abs(rep["sum_s"] - rep["wall_s"]) <= 0.05 * rep["wall_s"]
        tracks = timeline.build_tracks(events)
        assert "span.stream.pipeline.drain" in tracks
        assert tracks["span.stream.pipeline.drain"]["count"] == 3
        assert "span.stream.snapshot" in tracks
        # the helper runs end to end on real tracks (the value itself
        # is timing-dependent on CPU; the bench pins the A/B claim)
        frac = timeline.overlap_fraction(
            tracks["span.stream.snapshot"]["intervals"],
            tracks["span.stream.pipeline.drain"]["intervals"]
            + tracks["span.stream.segment"]["intervals"],
        )
        assert 0.0 <= frac <= 1.0


# ------------------------------------------------ real durable stream


def _port_col(wkts):
    from mosaic_tpu.core.geometry import wkt
    from mosaic_tpu_torch.core.types import PackedGeometry

    c = wkt.from_wkt(wkts)
    return PackedGeometry(
        xy=np.asarray(c.xy), ring_offsets=np.asarray(c.ring_offsets),
        part_offsets=np.asarray(c.part_offsets),
        geom_offsets=np.asarray(c.geom_offsets),
        geom_type=np.asarray(c.geom_type), srid=np.asarray(c.srid),
    )


@pytest.fixture(scope="module")
def stream_setup():
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.sql.join import build_chip_index
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    grid = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    col = _port_col(["POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))"])
    index = build_chip_index(
        tessellate(col, grid, 3, keep_core_geoms=False), device="cpu"
    )
    rng = np.random.default_rng(0)
    sj = StreamJoin(index, grid, 3, prefetch=True)
    ring = ring_from_host(
        [rng.uniform((-25, -25), (35, 20), (2048, 2)) for _ in range(3)],
        device="cpu",
    )
    return sj, ring


class TestRealDurableRunAttribution:
    def test_attribution_partitions_a_real_run(
        self, stream_setup, tmp_path
    ):
        sj, ring = stream_setup
        with telemetry.capture() as events:
            sj.run_durable(
                ring, 6, run_dir=str(tmp_path), snapshot_every=2
            )
        rep = timeline.attribute(events)
        assert rep["window"]["source"] == "stream_stage.durable_loop"
        assert abs(rep["sum_s"] - rep["wall_s"]) <= 0.05 * rep["wall_s"]
        # segments dominate a healthy CPU run; the snapshot D2H spans
        # (prefetch=True pulls cells) show up as transfer time
        assert rep["classes"]["device"]["seconds"] > 0
        assert rep["classes"]["transfer"]["seconds"] > 0
        assert rep["classes"]["host_callback"]["seconds"] > 0
        tracks = timeline.build_tracks(events)
        assert "span.stream.segment" in tracks
        assert tracks["span.stream.segment"]["count"] == 3
        assert "span.dispatch.transfer.d2h" in tracks

    def test_stall_report_cli_on_a_real_trail(
        self, stream_setup, tmp_path, monkeypatch, capsys
    ):
        sj, ring = stream_setup
        with telemetry.capture() as events:
            sj.run_durable(
                ring, 6, run_dir=str(tmp_path / "run"), snapshot_every=2
            )
            # the single-batch rate stream_bench would have measured
            telemetry.record(
                "stream_stage", stage="single_batch", seconds=0.001,
                batch=2048, points_per_sec=2048 / 0.001,
            )
        trail = str(tmp_path / "t.jsonl")
        export.write_jsonl(events, trail)
        out = str(tmp_path / "stall.json")
        assert stall_report.main([trail, "--out", out]) == 0
        last = capsys.readouterr().out.strip().splitlines()[-1]
        rep = json.loads(last)
        assert rep["metric"] == "stall_report"
        assert rep["sum_ok"] is True
        assert rep["loss"]["sustained_frac"] > 0
        lc = rep["loss"]["loss_classes"]
        assert abs(
            sum(lc.values()) + rep["loss"]["ideal_s"] - rep["wall_s"]
        ) <= 0.05 * rep["wall_s"]
        with open(out) as f:
            assert json.load(f)["metric"] == "stall_report"

    def test_stall_report_on_a_stage_timed_stream_trail(
        self, stream_setup, tmp_path, capsys
    ):
        from mosaic_tpu_torch.obs import trace

        sj, ring = stream_setup
        shares = {}
        for on in (False, True):
            trace.stage_timing(on)
            try:
                with telemetry.capture() as events:
                    sj.run(ring, 6)
            finally:
                trace.stage_timing(False)
            trail = str(tmp_path / f"t{int(on)}.jsonl")
            export.write_jsonl(events, trail)
            assert stall_report.main([trail]) == 0
            rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            assert rep["window"]["source"] == "stream_stage.join_loop"
            assert rep["sum_ok"] is True
            shares[on] = rep["classes"]["device"]["share"]
        # a run's loop and its wait on the fold pull read as device
        # only from the stage spans; without them the run is all idle
        assert shares[False] == 0.0
        assert shares[True] > 0.0

    def test_injected_slowdown_lands_in_the_right_class(
        self, stream_setup, tmp_path, monkeypatch, capsys
    ):
        sj, ring = stream_setup
        with telemetry.capture() as events:
            sj.run_durable(
                ring, 6, run_dir=str(tmp_path / "run"), snapshot_every=2
            )
        trail = str(tmp_path / "t.jsonl")
        export.write_jsonl(events, trail)

        def run(extra):
            assert stall_report.main([trail, *extra]) == 0
            return json.loads(
                capsys.readouterr().out.strip().splitlines()[-1]
            )

        base = run([])
        slow = run(["--inject-slowdown", "span.stream.snapshot:25"])
        b = base["classes"]["host_callback"]
        s = slow["classes"]["host_callback"]
        # the stall must grow in ITS class: 5x the seconds, or — on a
        # warm tiny window — saturate most of the wall
        assert (
            s["seconds"] > 5 * max(b["seconds"], 1e-9)
            or s["share"] > 0.6
        ), (b, s)
        assert s["share"] > b["share"], (b, s)
        assert slow["sum_ok"] is True

    def test_diff_against_itself_is_zero(
        self, stream_setup, tmp_path, monkeypatch, capsys
    ):
        sj, ring = stream_setup
        with telemetry.capture() as events:
            sj.run_durable(
                ring, 6, run_dir=str(tmp_path / "run"), snapshot_every=3
            )
        trail = str(tmp_path / "t.jsonl")
        export.write_jsonl(events, trail)
        monkeypatch.setattr(
            "sys.argv", ["stall_report", trail, "--against", trail]
        )
        assert stall_report.main() == 0
        rep = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]
        )
        assert all(
            v["seconds"] == 0 and v["share"] == 0
            for v in rep["diff"].values()
        )


# -------------------------------------------- seg-loop compile hoist


class TestSegLoopCompileHoist:
    """The reference hoists its seg_loop trace+compile out of
    ``stream.segment[0]`` under a ``dispatch.compile`` span. The port
    compiles nothing per shape: its hoist loads the kernel library
    before the segment loop on the card only, and on the CPU records
    nothing."""

    def test_segment0_compile_hoisted(self, stream_setup, tmp_path):
        from mosaic_tpu_torch.sql.stream import StreamJoin

        sj, ring = stream_setup
        with telemetry.capture() as events:
            sj.run_durable(ring, 5, run_dir=str(tmp_path), snapshot_every=2)
        spans = [e for e in events if e["event"] == "span"]
        assert not [e for e in spans if e["name"] == "dispatch.compile"]
        assert [e for e in spans if e["name"] == "stream.segment"]
        # the card's branch: one dispatch.compile span, classified compile
        fake = types.SimpleNamespace(
            _loaded=False, device=torch.device("cuda"),
            _load_kernels=lambda: ["pip"],
        )
        with telemetry.capture() as ev2:
            StreamJoin._warm_seg_loop(fake)
        (comp,) = [e for e in ev2 if e["event"] == "span"]
        assert comp["name"] == "dispatch.compile"
        assert comp["site"] == "stream.seg_loop"
        assert comp["libraries"] == "['pip']"
        assert timeline.classify_key("span.dispatch.compile") == "compile"
        assert timeline.attribute(ev2)["classes"]["compile"]["share"] == 1.0


# ------------------------------------------------ equal to the reference


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_attribution_equals_the_reference_exactly(seed):
    events = synthetic_trail(seed=seed)
    port, ref = timeline.attribute(events), ref_timeline.attribute(events)
    assert port == ref
    assert sum(c["seconds"] for c in port["classes"].values()) == pytest.approx(
        port["wall_s"], rel=1e-6)
    assert timeline.build_tracks(events) == ref_timeline.build_tracks(events)
    w = (101.0, 103.0 + seed)
    assert timeline.attribute(events, window=w) == ref_timeline.attribute(
        events, window=w)


def test_port_stream_trail_attributes_as_the_reference(stream_setup, tmp_path):
    sj, ring = stream_setup
    with telemetry.capture() as events:
        sj.run_durable(ring, 6, run_dir=str(tmp_path), snapshot_every=2,
                       pipeline=True)
    assert timeline.attribute(events) == ref_timeline.attribute(events)
    assert timeline.intervals(events) == ref_timeline.intervals(events)
