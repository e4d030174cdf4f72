"""The port's observability core (`mosaic_tpu_torch/obs`): spans and
cross-thread propagation, typed metrics and the event bridge, the
exporters (JSONL / Chrome trace / Prometheus), the telemetry satellites,
the durable stream's single trace, the perf gate and the trace report.

Mirrors `tests/test_obs.py` case for case on the port's own spine. Beyond
the mirror, the same seeded synthetic trail goes through both packages:
``trace_summary`` and ``chrome_trace`` must be equal, the Prometheus text
of the same events folded by each package's bridge must be byte-equal,
and a trail written by either package must read back equal in the other.
"""

import json
import logging
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from mosaic_tpu import obs as ref_obs
from mosaic_tpu.obs import metrics as ref_metrics
from mosaic_tpu_torch import obs
from mosaic_tpu_torch.obs import metrics as obs_metrics
from mosaic_tpu_torch.runtime import faults, telemetry
from mosaic_tpu_torch.tools import perf_gate, trace_report
from torch_obs_fixtures import reset_port_plane, synthetic_trail

REPO = Path(__file__).parent.parent


@pytest.fixture(autouse=True)
def _fresh_plane():
    reset_port_plane()
    yield


# ------------------------------------------------------------------ spans


class TestSpans:
    def test_ids_nesting_and_parent_links(self):
        with telemetry.capture() as events:
            with obs.span("outer", a=1):
                with obs.span("inner"):
                    pass
        spans = {e["name"]: e for e in events if e["event"] == "span"}
        outer, inner = spans["outer"], spans["inner"]
        assert len(outer["trace_id"]) == 32
        assert len(outer["span_id"]) == 16
        assert inner["trace_id"] == outer["trace_id"]
        assert inner["parent_id"] == outer["span_id"]
        assert outer["parent_id"] is None
        assert outer["a"] == 1
        assert outer["seconds"] >= inner["seconds"] >= 0.0
        assert inner["seq"] < outer["seq"]

    def test_exception_stamps_error_and_reraises(self):
        with telemetry.capture() as events:
            with pytest.raises(ValueError):
                with obs.span("doomed"):
                    raise ValueError("boom")
        (s,) = [e for e in events if e["event"] == "span"]
        assert s["name"] == "doomed" and s["error"] == "ValueError"

    def test_event_stamping_inside_and_outside(self):
        with telemetry.capture() as events:
            telemetry.record("before")
            with obs.span("scope") as sp:
                telemetry.record("inside")
                telemetry.record("explicit", trace_id="mine")
            telemetry.record("after")
        by = {e["event"]: e for e in events if e["event"] != "span"}
        assert "trace_id" not in by["before"]
        assert by["inside"]["trace_id"] == sp.context.trace_id
        assert by["inside"]["span_id"] == sp.context.span_id
        assert by["explicit"]["trace_id"] == "mine"
        assert "trace_id" not in by["after"]

    def test_detached_span_does_not_become_ambient_parent(self):
        with telemetry.capture() as events:
            root = obs.start_span("request", detached=True)
            with obs.span("sibling"):
                pass
            root.end()
        spans = {e["name"]: e for e in events if e["event"] == "span"}
        assert spans["sibling"]["trace_id"] != spans["request"]["trace_id"]
        assert spans["sibling"]["parent_id"] is None

    def test_end_is_idempotent(self):
        with telemetry.capture() as events:
            sp = obs.start_span("once", detached=True)
            assert sp.end() is not None
            assert sp.end() is None
        assert sum(e["event"] == "span" for e in events) == 1

    def test_cross_thread_adoption_joins_the_trace(self):
        with telemetry.capture() as events:
            sinks = telemetry.current_sinks()
            with obs.span("caller") as sp:
                ctx = obs.current_context()

                def work():
                    telemetry.adopt_sinks(sinks)
                    obs.adopt_context(ctx)
                    telemetry.record("worker_event")
                    with obs.span("worker_span"):
                        pass

                t = threading.Thread(target=work)  # lint: thread-context-adoption-ok (this IS the adoption test fixture; no fault plans in scope)
                t.start()
                t.join()
        spans = {e["name"]: e for e in events if e["event"] == "span"}
        ev = next(e for e in events if e["event"] == "worker_event")
        assert ev["trace_id"] == sp.context.trace_id
        assert spans["worker_span"]["trace_id"] == sp.context.trace_id
        assert spans["worker_span"]["parent_id"] == sp.context.span_id
        summ = obs.trace_summary(events)
        assert len(summ) == 1
        (t_sum,) = summ.values()
        assert t_sum["roots"] == 1 and not t_sum["orphans"]

    def test_watchdog_worker_inherits_the_span(self):
        from mosaic_tpu_torch.runtime import watchdog

        with telemetry.capture() as events:
            with obs.span("guarded") as sp:
                with faults.stalls(0.0, n=1, sites=("unit.site",)):
                    watchdog.guard(
                        "unit.site",
                        lambda: telemetry.record("from_worker"),
                        default_s=30.0,
                    )
        ev = next(e for e in events if e["event"] == "from_worker")
        assert ev["trace_id"] == sp.context.trace_id


# ---------------------------------------------------------------- metrics


class TestMetrics:
    def test_counter_gauge_histogram(self):
        reg = obs_metrics.Registry()
        c = reg.counter("c.requests", "reqs")
        c.inc()
        c.inc(2, reason="deadline")
        assert c.value() == 1
        assert c.value(reason="deadline") == 2
        g = reg.gauge("g.depth")
        g.set(7)
        g.set(3)
        assert g.value() == 3.0
        h = reg.histogram("h.lat", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        hv = h.value()
        assert hv["counts"] == [1, 1, 1, 1]
        assert hv["count"] == 4
        assert hv["sum"] == pytest.approx(5.555)

    def test_kind_conflict_raises(self):
        reg = obs_metrics.Registry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")

    def test_snapshot_is_json_clean(self):
        reg = obs_metrics.Registry()
        reg.counter("a").inc(site="s1")
        reg.histogram("b", buckets=(1.0,)).observe(0.5)
        snap = {name: m.snapshot() for name, m in reg._metrics.items()}
        parsed = json.loads(json.dumps(snap))
        assert parsed["a"]["series"][0]["labels"] == {"site": "s1"}
        assert parsed["b"]["series"][0]["value"]["buckets"] == [1.0]

    def test_event_bridge_counts_runtime_events(self):
        before = obs.counter("join.cap_overflows").value(stage="unit_t")
        shed_before = obs.counter("serve.requests_shed").value(
            reason="unit_reason"
        )
        telemetry.record("capacity_overflow", stage="unit_t", attempt=1)
        telemetry.record("serve_shed", reason="unit_reason")
        assert (
            obs.counter("join.cap_overflows").value(stage="unit_t")
            == before + 1
        )
        assert (
            obs.counter("serve.requests_shed").value(reason="unit_reason")
            == shed_before + 1
        )

    def test_prometheus_exposition(self):
        reg = obs_metrics.Registry()
        reg.counter("serve.requests_shed", "shed requests").inc(
            3, reason="deadline"
        )
        reg.gauge("queue.depth").set(2)
        reg.histogram("lat", buckets=(0.1, 1.0)).observe(0.05)
        snap = {name: m.snapshot() for name, m in reg._metrics.items()}
        text = obs.prometheus_text(snap)
        assert "# TYPE serve_requests_shed counter" in text
        assert "# HELP serve_requests_shed shed requests" in text
        assert 'serve_requests_shed{reason="deadline"} 3' in text
        assert "queue_depth 2.0" in text
        assert 'lat_bucket{le="0.1"} 1' in text
        assert 'lat_bucket{le="+Inf"} 1' in text
        assert "lat_count 1" in text
        assert text.endswith("\n")

    def test_bridged_prometheus_text_is_byte_equal_to_the_reference(
        self, monkeypatch
    ):
        """The same events folded by each package's bridge into a fresh
        registry render the same Prometheus text, byte for byte (the
        reference's process registry is swapped for the test, never
        reset)."""
        events = synthetic_trail(seed=3)
        port_reg, ref_reg = obs_metrics.Registry(), ref_metrics.Registry()
        monkeypatch.setattr(obs_metrics, "REGISTRY", port_reg)
        monkeypatch.setattr(ref_metrics, "REGISTRY", ref_reg)
        for e in events:
            obs_metrics._on_event(e)
            ref_metrics._on_event(e)
        port_text = obs.prometheus_text()
        assert port_text == ref_obs.prometheus_text()
        assert "serve_request_seconds_count" in port_text
        assert 'obs_compile_count{kind="serve_cold"}' in port_text


# --------------------------------------------------------------- exporters


def _span_evt(name, trace, span_id, parent, seconds=0.25, **attrs):
    return {
        "event": "span", "seq": 0, "ts_mono": 100.0 + seconds,
        "name": name, "trace_id": trace, "span_id": span_id,
        "parent_id": parent, "seconds": seconds,
        "start_mono": 100.0, **attrs,
    }


class TestExport:
    def test_jsonl_roundtrip(self, tmp_path):
        events = [
            {"event": "a", "seq": 0, "ts_mono": 1.0, "x": 1},
            _span_evt("s", "t1", "a1", None),
        ]
        p = tmp_path / "trail.jsonl"
        assert obs.write_jsonl(events, str(p)) == 3
        rows = obs.read_trail(str(p))
        assert rows[0]["event"] == "incarnation"
        assert rows[0]["incarnation"] == telemetry.INCARNATION
        assert rows[1:] == events
        assert obs.write_jsonl(rows, str(p)) == 3

    def test_read_trail_accepts_bench_artifact(self, tmp_path):
        stages = [{"event": "stream_stage", "stage": "x", "seconds": 1.0}]
        artifact = {"metric": "m", "value": 1, "detail": {"stages": stages}}
        p = tmp_path / "bench.json"
        p.write_text(json.dumps(artifact) + "\n")
        assert obs.read_trail(str(p)) == stages

    def test_chrome_trace_shape(self):
        events = [
            _span_evt("root", "t1", "a1", None, seconds=0.5),
            _span_evt("child", "t1", "b2", "a1", seconds=0.2),
            {"event": "transient_retry", "seq": 2, "ts_mono": 100.1,
             "trace_id": "t1", "span_id": "b2", "label": "x"},
        ]
        doc = obs.chrome_trace(events)
        json.loads(json.dumps(doc))
        evs = doc["traceEvents"]
        xs = [e for e in evs if e["ph"] == "X"]
        inst = [e for e in evs if e["ph"] == "i"]
        assert len(xs) == 2 and len(inst) == 1
        root = next(e for e in xs if e["name"] == "root")
        child = next(e for e in xs if e["name"] == "child")
        assert root["ts"] == pytest.approx(100.0 * 1e6)
        assert root["dur"] == pytest.approx(0.5 * 1e6)
        assert root["tid"] == child["tid"] == inst[0]["tid"]
        assert child["args"]["parent_id"] == "a1"
        for e in xs:
            assert {"name", "ph", "ts", "dur", "pid", "tid"} <= set(e)

    def test_trace_summary_flags_orphans_and_roots(self):
        events = [
            _span_evt("root", "t1", "a1", None),
            _span_evt("ok_child", "t1", "b2", "a1"),
            _span_evt("orphan", "t1", "c3", "missing"),
            _span_evt("other_root", "t2", "d4", None),
        ]
        summ = obs.trace_summary(events)
        assert summ["t1"]["spans"] == 3
        assert summ["t1"]["roots"] == 1
        assert summ["t1"]["orphans"] == ["orphan"]
        assert summ["t2"]["roots"] == 1 and not summ["t2"]["orphans"]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_summary_and_chrome_trace_equal_the_reference(self, seed):
        events = synthetic_trail(seed=seed)
        assert obs.trace_summary(events) == ref_obs.trace_summary(events)
        assert obs.chrome_trace(events) == ref_obs.chrome_trace(events)

    @pytest.mark.parametrize("writer", ["port", "reference"])
    def test_trails_read_in_both_directions(self, tmp_path, writer):
        """A trail written by either package reads back equal in both,
        incarnation header included."""
        events = synthetic_trail(seed=5, n=20)
        p = str(tmp_path / f"{writer}.jsonl")
        w = obs if writer == "port" else ref_obs
        assert w.write_jsonl(events, p) == len(events) + 1
        port_rows, ref_rows = obs.read_trail(p), ref_obs.read_trail(p)
        assert port_rows == ref_rows
        assert port_rows[0]["event"] == "incarnation"
        assert port_rows[1:] == events


# ------------------------------------------------- telemetry satellites


class _FormatProbe:
    def __init__(self):
        self.formats = 0

    def __repr__(self):
        self.formats += 1
        return "probe"

    __str__ = __repr__


class TestRecordHotPath:
    def test_disabled_logging_does_no_formatting(self):
        logger = logging.getLogger("mosaic_tpu_torch.runtime")
        saved = (logger.level, logger.handlers[:])
        logger.handlers[:] = []
        logger.setLevel(logging.WARNING)
        try:
            probe = _FormatProbe()
            evt = telemetry.record("hot_path_unit", payload=probe)
            assert evt["payload"] is probe
            assert probe.formats == 0
            assert logger.handlers == []
            assert logger.level == logging.WARNING
        finally:
            logger.setLevel(saved[0])
            logger.handlers[:] = saved[1]
            # the recorder's ring holds the probe: drop it
            reset_port_plane()

    def test_enabled_logging_still_formats(self):
        import io

        logger = logging.getLogger("mosaic_tpu_torch.runtime")
        saved = (logger.level, logger.handlers[:], logger.propagate)
        buf = io.StringIO()
        logger.handlers[:] = [logging.StreamHandler(buf)]
        logger.setLevel(logging.INFO)
        logger.propagate = False
        try:
            probe = _FormatProbe()
            telemetry.record("hot_path_unit", payload=probe)
            assert probe.formats >= 1
            assert "hot_path_unit" in buf.getvalue()
        finally:
            logger.setLevel(saved[0])
            logger.handlers[:] = saved[1]
            logger.propagate = saved[2]
            reset_port_plane()

    def test_micro_benchmark_disabled_record_is_cheap(self):
        logger = logging.getLogger("mosaic_tpu_torch.runtime")
        saved = logger.level
        logger.setLevel(logging.ERROR)
        try:
            t0 = time.perf_counter()
            for _ in range(20_000):
                telemetry.record("hot_path_bench", a=1, b="x")
            elapsed = time.perf_counter() - t0
        finally:
            logger.setLevel(saved)
        assert elapsed < 2.0, f"record() too slow: {elapsed:.3f}s / 20k"


class TestTimedErrorStamp:
    def test_exception_stamps_error_type_and_reraises(self):
        with telemetry.capture() as events:
            with pytest.raises(KeyError):
                with telemetry.timed("stage_unit", stage="s"):
                    raise KeyError("gone")
        (e,) = [x for x in events if x["event"] == "stage_unit"]
        assert e["error"] == "KeyError"
        assert e["seconds"] >= 0.0

    def test_success_has_no_error_field(self):
        with telemetry.capture() as events:
            with telemetry.timed("stage_unit", stage="s"):
                pass
        (e,) = [x for x in events if x["event"] == "stage_unit"]
        assert "error" not in e


class TestSummarizeNearestRank:
    @pytest.mark.parametrize(
        "n,p50,p90,p99",
        [
            (1, 1.0, 1.0, 1.0),
            (2, 1.0, 2.0, 2.0),
            (3, 2.0, 3.0, 3.0),
            (10, 5.0, 9.0, 10.0),
            (100, 50.0, 90.0, 99.0),
        ],
    )
    def test_exact_ranks(self, n, p50, p90, p99):
        events = [
            {"event": "e", "seconds": float(v)} for v in range(1, n + 1)
        ]
        s = telemetry.summarize(events, event="e")
        assert s["count"] == n
        assert (s["p50"], s["p90"], s["p99"]) == (p50, p90, p99)
        assert s["max"] == float(n)

    def test_n4_regression_pin(self):
        s = telemetry.summarize(
            [{"event": "e", "seconds": float(v)} for v in (1, 2, 3, 4)],
            event="e",
        )
        assert s["p50"] == 2.0


# --------------------------------------------- durable stream: one trace


@pytest.fixture(scope="module")
def stream_setup():
    from mosaic_tpu.core.geometry import wkt
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.core.types import PackedGeometry
    from mosaic_tpu_torch.sql.join import build_chip_index
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    grid = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    c = wkt.from_wkt(["POLYGON ((1 1, 13 2, 12 11, 6 14, 2 9, 1 1))"])
    col = PackedGeometry(
        xy=np.asarray(c.xy), ring_offsets=np.asarray(c.ring_offsets),
        part_offsets=np.asarray(c.part_offsets),
        geom_offsets=np.asarray(c.geom_offsets),
        geom_type=np.asarray(c.geom_type), srid=np.asarray(c.srid),
    )
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


class TestDurableStreamTrace:
    def test_run_durable_is_one_connected_trace(self, stream_setup, tmp_path):
        sj, ring = stream_setup
        with telemetry.capture() as events:
            sj.run_durable(ring, 6, run_dir=str(tmp_path), snapshot_every=2)
        spans = [e for e in events if e["event"] == "span"]
        summ = obs.trace_summary(events)
        assert len(summ) == 1, summ
        ((tid, t),) = summ.items()
        assert t["roots"] == 1 and not t["orphans"], t
        names = t["names"]
        assert "stream.durable_run" in names
        assert names.count("stream.segment") == 3
        assert names.count("stream.snapshot") == 3
        saved = [e for e in events if e["event"] == "snapshot_saved"]
        assert saved and all(e["trace_id"] == tid for e in saved)
        root = next(
            s for s in spans if s["name"] == "stream.durable_run"
        )
        segs = [s for s in spans if s["name"] == "stream.segment"]
        assert all(s["parent_id"] == root["span_id"] for s in segs)

    def test_kill_and_resume_join_one_trace(self, stream_setup, tmp_path):
        sj, ring = stream_setup
        clean = sj.run(ring, 9)
        d = str(tmp_path / "run")
        with telemetry.capture() as events:
            with pytest.raises(RuntimeError):
                with faults.inject(
                    fail_first=99, skip_first=2,
                    sites=("stream.scan_step",),
                    exc_factory=lambda s: RuntimeError("device loss"),
                ):
                    sj.run_durable(ring, 9, run_dir=d, snapshot_every=2)
            r = sj.resume(d, ring)
        assert (r.checksum, r.matches, r.overflow) == (
            clean.checksum, clean.matches, clean.overflow
        )
        roots = [
            e for e in events
            if e["event"] == "span" and e["name"] == "stream.durable_run"
        ]
        assert len(roots) == 2
        killed, resumed = roots
        assert killed["error"] == "RuntimeError"
        assert resumed["trace_id"] == killed["trace_id"]
        assert resumed["parent_id"] == killed["span_id"]
        assert resumed["resumed_from"] == 4
        summ = obs.trace_summary(events)
        assert len(summ) == 1
        (t,) = summ.values()
        assert t["roots"] == 1 and not t["orphans"], t


# ------------------------------------------------------------- perf gate


def _mk_trail(tmp_path, name, stages):
    """stages: {stage_name: (seconds, count)} -> trail file path."""
    events = []
    for stage, (seconds, count) in stages.items():
        for _ in range(count):
            events.append({
                "event": "bench_stage", "stage": stage,
                "seconds": seconds / count, "seq": 0, "ts_mono": 0.0,
            })
    p = tmp_path / name
    obs.write_jsonl(events, str(p))
    return str(p)


BASE_STAGES = {
    "compile": (4.0, 2),
    "join_loop": (2.0, 2),
    "dispatch": (0.5, 10),
}


def _golden_of(fresh):
    return {
        "tolerance": 3.0, "odds_floor": 0.02,
        "stages": {
            k: {"odds": v["odds"], "require": True}
            for k, v in fresh.items()
        },
    }


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestPerfGate:
    def test_green_on_identical_and_uniformly_slower_runs(self, tmp_path):
        trail = _mk_trail(tmp_path, "a.jsonl", BASE_STAGES)
        fresh = perf_gate.stage_odds(obs.read_trail(trail))
        golden = _golden_of(fresh)
        ok, verdicts = perf_gate.evaluate(fresh, golden)
        assert ok, verdicts
        slow = _mk_trail(tmp_path, "slow.jsonl", {
            k: (s * 5, c) for k, (s, c) in BASE_STAGES.items()
        })
        ok, verdicts = perf_gate.evaluate(
            perf_gate.stage_odds(obs.read_trail(slow)), golden
        )
        assert ok, verdicts

    def test_red_on_10x_single_stage_slowdown(self, tmp_path):
        trail = _mk_trail(tmp_path, "a.jsonl", BASE_STAGES)
        golden = _golden_of(perf_gate.stage_odds(obs.read_trail(trail)))
        for stage in ("compile", "join_loop", "dispatch"):
            bad = _mk_trail(tmp_path, f"bad_{stage}.jsonl", {
                k: ((s * 10 if k == stage else s), c)
                for k, (s, c) in BASE_STAGES.items()
            })
            ok, verdicts = perf_gate.evaluate(
                perf_gate.stage_odds(obs.read_trail(bad)), golden
            )
            assert not ok, (stage, verdicts)
            assert verdicts[f"bench_stage.{stage}"]["status"] == "SLOW"

    def test_trail_pools_isolate_odds(self, tmp_path, capsys):
        small = _mk_trail(tmp_path, "small.jsonl", {
            "light": (0.02, 3), "heavy": (0.04, 3),
        })
        huge = _mk_trail(tmp_path, "huge.jsonl", {"compile": (60.0, 1)})
        golden = str(tmp_path / "golden.json")
        assert perf_gate.main([
            "--update", "--golden", golden, "--trail", small, "--trail", huge,
        ]) == 0
        capsys.readouterr()
        assert perf_gate.main([
            "--golden", golden, "--trail", small, "--trail", huge,
            "--inject-slowdown", "bench_stage.heavy:10",
        ]) == 1
        out = _last_json(capsys)
        assert out["stages"]["bench_stage.heavy"]["status"] == "SLOW"
        assert out["stages"]["bench_stage.compile"]["ok"] is True

    def test_missing_required_stage_is_red(self, tmp_path):
        golden = {
            "tolerance": 3.0, "odds_floor": 0.02,
            "stages": {
                "bench_stage.vanished": {"odds": 0.5, "require": True},
            },
        }
        trail = _mk_trail(tmp_path, "a.jsonl", {"other": (1.0, 1)})
        ok, verdicts = perf_gate.evaluate(
            perf_gate.stage_odds(obs.read_trail(trail)), golden
        )
        assert not ok
        assert (
            verdicts["bench_stage.vanished"]["status"]
            == "MISSING_REQUIRED"
        )

    def test_cli_update_then_gate_and_inject(self, tmp_path, monkeypatch,
                                             capsys):
        """The CLI through ``sys.argv``, as ``python -m`` runs it; the
        golden ``--update`` writes names the card (none here)."""
        trail = _mk_trail(tmp_path, "a.jsonl", BASE_STAGES)
        golden = str(tmp_path / "golden.json")
        monkeypatch.setattr(perf_gate, "card_name", lambda: "NVIDIA Test, 1.00 W")
        monkeypatch.setattr("sys.argv", [
            "perf_gate", "--update", "--golden", golden, "--trail", trail,
        ])
        assert perf_gate.main() == 0
        capsys.readouterr()
        with open(golden) as f:
            assert "NVIDIA Test, 1.00 W" in json.load(f)["note"]
        monkeypatch.setattr("sys.argv", [
            "perf_gate", "--golden", golden, "--trail", trail,
        ])
        assert perf_gate.main() == 0
        assert _last_json(capsys)["pass"] is True
        monkeypatch.setattr("sys.argv", [
            "perf_gate", "--golden", golden, "--trail", trail,
            "--inject-slowdown", "bench_stage.join_loop:10",
        ])
        assert perf_gate.main() == 1
        assert _last_json(capsys)["pass"] is False

    def test_committed_golden_parses_and_gates_its_own_stages(self):
        """The committed card golden is well-formed: it names an NVIDIA
        card and its power limit, its stage odds are positive, every
        stage key names a real stage, and its own stages gate green."""
        with open(perf_gate.DEFAULT_GOLDEN) as f:
            golden = json.load(f)
        assert 1.0 < golden["tolerance"] <= 10.0
        assert "NVIDIA" in golden["note"] and " W" in golden["note"]
        assert golden["stages"], "empty golden gates nothing"
        for key, g in golden["stages"].items():
            assert g["odds"] > 0, key
            assert key.split(".")[0] in (
                "serve_stage", "stream_stage", "serve_request",
                "recheck_narrow", "quarantine_stage", "snapshot_saved",
                "probe_stage", "raster_stage", "dispatch_stage",
                "expr_stage", "tune_stage", "router_stage",
                "overlay_stage", "epoch_stage", "knn_stage",
                "ops_stage",
            ), key
        fresh = {
            k: {"odds": g["odds"], "seconds": g["seconds"], "count": 1}
            for k, g in golden["stages"].items()
        }
        ok, verdicts = perf_gate.evaluate(fresh, golden)
        assert ok, verdicts


# ----------------------------------------------------------- trace report


class TestTraceReport:
    def test_stage_keys(self):
        assert trace_report.stage_key(
            {"event": "stream_stage", "stage": "x", "seconds": 1.0}
        ) == "stream_stage.x"
        assert trace_report.stage_key(
            {"event": "span", "name": "serve.request", "seconds": 1.0}
        ) == "span.serve.request"
        assert trace_report.stage_key(
            {"event": "serve_request", "seconds": 1.0}
        ) == "serve_request"
        assert trace_report.stage_key({"event": "no_seconds"}) is None

    def test_cli_report_and_diff(self, tmp_path, capsys):
        a = _mk_trail(tmp_path, "a.jsonl", BASE_STAGES)
        b = _mk_trail(tmp_path, "b.jsonl", {
            k: (s * 2 if k == "compile" else s, c)
            for k, (s, c) in BASE_STAGES.items()
        })
        trace_report.main([a])
        out = _last_json(capsys)
        assert out["metric"] == "trace_report"
        assert out["stages"]["bench_stage.compile"]["count"] == 2
        assert sum(
            s["share"] for s in out["stages"].values()
        ) == pytest.approx(1.0, abs=0.01)
        trace_report.main([b, "--against", a])
        d = _last_json(capsys)["diff"]["bench_stage.compile"]
        assert d["total_ratio"] == pytest.approx(2.0, abs=0.01)
        assert d["share_delta"] > 0

    def test_diff_tolerates_one_sided_stages(self, tmp_path, capsys):
        old = _mk_trail(tmp_path, "old.jsonl", BASE_STAGES)
        new = _mk_trail(tmp_path, "new.jsonl", {
            **BASE_STAGES,
            "probe_light": (0.2, 1),
            "probe_heavy": (0.4, 1),
        })
        trace_report.main([new, "--against", old])
        d = _last_json(capsys)["diff"]["bench_stage.probe_heavy"]
        assert d["only_in"] == "fresh"
        assert d["share_delta"] is None and d["total_ratio"] is None
        trace_report.main([old, "--against", new])
        out = _last_json(capsys)
        assert out["diff"]["bench_stage.probe_heavy"]["only_in"] == "base"
        assert out["diff"]["bench_stage.compile"].get("only_in") is None

    def test_diff_against_summary_only_artifact(self, tmp_path, capsys):
        fresh = _mk_trail(tmp_path, "fresh.jsonl", BASE_STAGES)
        art = tmp_path / "hist.json"
        art.write_text(json.dumps({
            "metric": "m", "value": 1,
            "detail": {"stages": {
                "bench_stage.compile": {"total_s": 2.0, "count": 2},
            }},
        }) + "\n")
        trace_report.main([fresh, "--against", str(art)])
        d = _last_json(capsys)["diff"]["bench_stage.compile"]
        assert d.get("only_in") is None
        assert d["total_ratio"] == pytest.approx(2.0, abs=0.01)

    def test_stage_key_skips_non_dict_and_non_numeric(self):
        assert trace_report.stage_key("bench_stage.seconds") is None
        assert trace_report.stage_key({"seconds": None}) is None
        assert trace_report.stage_key(
            {"stage_key": "x", "seconds": 1.0}
        ) == "x"


# ------------------------------------- prometheus label-value escaping


_LABEL_RE = re.compile(r'="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class TestPrometheusLabelEscaping:
    HOSTILE = [
        'a\\b"c\nd',
        "C:\\temp\\trail.jsonl",
        'say "hi"',
        "line1\nline2",
        "\\n",
        'trailing\\',
    ]

    @pytest.mark.parametrize("value", HOSTILE)
    def test_hostile_value_round_trips(self, value):
        reg = obs_metrics.Registry()
        reg.counter("hostile").inc(site=value)
        snap = {n: m.snapshot() for n, m in reg._metrics.items()}
        text = obs.prometheus_text(snap)
        line = next(
            ln for ln in text.splitlines() if ln.startswith("hostile{")
        )
        (escaped,) = _LABEL_RE.findall(line)
        assert "\n" not in line
        assert _unescape_label(escaped) == value
        assert text == ref_obs.prometheus_text(snap)

    def test_distinct_hostile_values_stay_distinct(self):
        reg = obs_metrics.Registry()
        reg.counter("h2").inc(site="a\nb")
        reg.counter("h2").inc(2, site="a\\nb")
        snap = {n: m.snapshot() for n, m in reg._metrics.items()}
        text = obs.prometheus_text(snap)
        lines = [
            ln for ln in text.splitlines() if ln.startswith("h2{")
        ]
        assert len(lines) == 2
        vals = {
            _unescape_label(_LABEL_RE.findall(ln)[0]) for ln in lines
        }
        assert vals == {"a\nb", "a\\nb"}


# ------------------------------------------ chrome trace class tracks


class TestChromeTraceClassTracks:
    def test_classified_spans_land_on_named_tracks(self):
        events = [
            _span_evt(
                "dispatch.transfer.h2d", "t1", "a1", None,
                seconds=0.1, nbytes=4096,
            ),
            _span_evt("stream.segment", "t1", "b2", None, seconds=0.5),
            {"event": "serve_stage", "stage": "queue_wait",
             "seconds": 0.02, "ts_mono": 100.5, "seq": 3,
             "trace_id": "t1"},
        ]
        doc = obs.chrome_trace(events)
        evs = doc["traceEvents"]
        track = [e for e in evs if e.get("cat") == "mosaic.timeline"]
        assert {e["args"]["class"] for e in track} == {
            "transfer", "queue_wait",
        }
        xfer = next(e for e in track if e["args"]["class"] == "transfer")
        assert xfer["ph"] == "X" and xfer["tid"] == 1002
        qw = next(e for e in track if e["args"]["class"] == "queue_wait")
        assert qw["ph"] == "X" and qw["tid"] == 1003
        assert qw["ts"] == pytest.approx((100.5 - 0.02) * 1e6)
        names = {
            (e["tid"], e["args"]["name"]) for e in evs
            if e.get("ph") == "M" and e["name"] == "thread_name"
        }
        assert (1002, "mosaic:transfer") in names
        assert (1003, "mosaic:queue_wait") in names
        assert any(
            e["ph"] == "X" and e.get("cat") == "mosaic"
            and e["name"] == "dispatch.transfer.h2d"
            for e in evs
        )
        json.loads(json.dumps(doc))

    def test_unclassified_trails_emit_no_tracks(self):
        doc = obs.chrome_trace(
            [_span_evt("custom.thing", "t1", "a1", None)]
        )
        assert not [
            e for e in doc["traceEvents"]
            if e.get("cat") == "mosaic.timeline" or e.get("ph") == "M"
        ]


# ------------------------------------------------- the installed plane


def test_obs_exports_and_install_order_match_the_reference():
    """The port's ``obs`` exports the reference's public names, and its
    import installs the bridge, the recorder, the SLO monitor and the
    health monitor on the port's spine, in the reference's order (in a
    fresh interpreter: tests here re-install observers)."""
    import subprocess
    import sys

    assert sorted(obs.__all__) == sorted(ref_obs.__all__)
    code = (
        "import sys\n"
        "from mosaic_tpu_torch.runtime import telemetry\n"
        "from mosaic_tpu_torch.obs import health, metrics, recorder, slo\n"
        "want = [metrics._on_event, recorder.RECORDER.observer,\n"
        "        slo.MONITOR.observer, health.MONITOR.observer]\n"
        "sys.exit(0 if telemetry._OBSERVERS == want else 1)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
